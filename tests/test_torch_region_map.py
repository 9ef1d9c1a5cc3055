"""The port's RegionMap (io/region_map.py) and KeyedStatCollector
(stats/keyed_collector.py) against the pinned RegionList and
StatCollector they subclass: the same add and BED sequences give the
same intervals, before and after collapse, and the same answers to every
query; a collector built from an index holds the same flanks, markers,
tables and dense sites.  RegionMap's insert stays linear: 50,000 flanks
on one chromosome, where the pinned scan takes minutes."""

import random
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # one intra-op thread per test worker

from fastquick_tpu_torch.align.opts import GapOpt  # noqa: E402
from fastquick_tpu_torch.index.builder import read_param  # noqa: E402
from fastquick_tpu_torch.io.region import RegionList  # noqa: E402
from fastquick_tpu_torch.io.region_map import RegionMap  # noqa: E402
from fastquick_tpu_torch.stats.collector import StatCollector  # noqa: E402
from fastquick_tpu_torch.stats.keyed_collector import (  # noqa: E402
    KeyedStatCollector,
)
from fastquick_tpu_torch.testing.synthworld import (  # noqa: E402
    build_synth_pe_world,
)

CHROMS = ("1", "2", "X")


def _adds(seed: int, n: int = 3000) -> list[tuple]:
    """Adds over several chromosomes; starts drawn from a narrow range so
    most repeat, with other ends (an add overwrites: the last end wins)."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        s = rng.randrange(1, 4000, 7)
        out.append(("add", rng.choice(CHROMS), s, s + rng.randrange(0, 300)))
    return out


def _bed(path, seed: int, n: int = 2000) -> str:
    """A BED with comment, track and browser lines, blank lines, `chr`
    prefixes in either case and repeated starts with other ends
    (read_region_list keeps the larger)."""
    rng = random.Random(seed)
    lines = ["# a comment", "track name=t", "browser position chr1:1-10",
             ""]
    for _ in range(n):
        s = rng.randrange(0, 5000, 11)
        chrom = rng.choice(("chr1", "CHR2", "1", "x", "chrX"))
        lines.append(f"{chrom}\t{s}\t{s + rng.randrange(1, 400)}\tname")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _ops(case: str, tmp_path) -> list[tuple]:
    if case.startswith("add"):
        return _adds(int(case[-1]))
    if case == "bed":
        return [("read", _bed(tmp_path / "t.bed", 7), True)]
    if case == "bed-uncollapsed":
        return [("read", _bed(tmp_path / "t.bed", 8), False)]
    if case == "bed-then-adds":  # adds after a collapse (new lists)
        return [("read", _bed(tmp_path / "t.bed", 9), True)] + _adds(9, 500)
    raise ValueError(case)


def _apply(rl: RegionList, ops: list[tuple]) -> RegionList:
    for op in ops:
        if op[0] == "add":
            rl.add(*op[1:])
        else:
            rl.read_region_list(op[1], collapse=op[2])
    return rl


def _queries(rl: RegionList, seed: int) -> list:
    rng = random.Random(seed)
    out = []
    for _ in range(500):
        chrom = rng.choice(CHROMS + ("Y",))
        s = rng.randrange(0, 5500)
        e = s + rng.randrange(0, 60)
        out.append((rl.is_overlapped(chrom, s),
                    rl.overlaps_interval(chrom, s, e),
                    rl.overlap_len(chrom, s, e)))
    return out


@pytest.mark.parametrize("case", ["add-1", "add-2", "add-3", "bed",
                                  "bed-uncollapsed", "bed-then-adds"])
def test_region_map_equals_region_list(case, tmp_path):
    ops = _ops(case, tmp_path)
    want = _apply(RegionList(), ops)
    got = _apply(RegionMap(), ops)
    assert got.regions == want.regions  # the order before collapse too
    assert got.collapsed == want.collapsed
    assert got.total_size() == want.total_size()  # collapses both
    assert got.regions == want.regions
    assert _queries(got, 1) == _queries(want, 1)
    other = _apply(RegionList(), _adds(4, 400))
    assert got.join_inner(other).regions == want.join_inner(other).regions
    assert (got.join_outer(other).regions
            == want.join_outer(other).regions)


def test_region_map_insert_is_linear():
    """50,000 flanks on one chromosome: ~0.1 s keyed, ~100 s scanned."""
    t0 = time.perf_counter()
    rl = RegionMap()
    for i in range(50_000):
        rl.add("1", 3200 * i + 1, 3200 * i + 500)
    rl.add("1", 1, 9)  # a repeated start: overwritten, not appended
    assert len(rl) == 50_000 and rl.regions["1"][0] == (1, 9)
    assert time.perf_counter() - t0 < 5.0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_region_map")
    w = build_synth_pe_world(tmp, n_markers=60, depth=1)
    new_ref = w["idx_prefix"] + ".FASTQuick.fa"
    bed = tmp / "target.bed"
    # a target over a third of the markers, every other one across the
    # left edge of its flank
    bed.write_text("".join(
        f"chr1\t{2500 * m - (300 if m % 2 else 100)}\t{2500 * m + 80}\n"
        for m in range(1, 61, 3)))
    return new_ref, str(bed)


@pytest.mark.parametrize("target", [False, True])
def test_keyed_collector_equals_pinned(world, target):
    new_ref, bed = world
    params = read_param(new_ref)
    opt = GapOpt()
    opt.flank_len = params["SHORT_FLANK_LENGTH"]
    opt.flank_long_len = params["LONG_FLANK_LENGTH"]
    want, got = StatCollector(), KeyedStatCollector()
    for c in (want, got):
        c.restore_vcf_sites(new_ref, opt)
        if target:
            c.set_target_region(bed)
    assert isinstance(got.target_region, RegionMap)
    # set_target_region puts join_inner's RegionList in place of the flanks
    assert isinstance(got.flank_region, RegionMap) != target
    assert sum(map(len, want.flank_region.regions.values())) > 0
    assert got.flank_region.regions == want.flank_region.regions
    assert got.target_region.regions == want.target_region.regions
    for f in ("num_short_marker", "num_long_marker", "num_xy_marker",
              "vcf_table", "dbsnp_table"):
        assert getattr(got, f) == getattr(want, f), f
    assert ([r.pos for r in got.vcf_rec_vec]
            == [r.pos for r in want.vcf_rec_vec])
    ws, gs = want.sites, got.sites
    assert gs.total == ws.total > 0
    for ch, d in ws.chroms.items():
        for k, v in d.items():
            np.testing.assert_array_equal(gs.chroms[ch][k], v,
                                          err_msg=f"{ch} {k}")
    np.testing.assert_array_equal(gs.gc, ws.gc)
    np.testing.assert_array_equal(gs.dbsnp, ws.dbsnp)
    assert ws.dbsnp.any()
