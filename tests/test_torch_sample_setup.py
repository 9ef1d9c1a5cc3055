"""align/sample_setup.py: the index's options, the sample's collector and
the exact engine, each held to the same set-up written out step by step,
and the engine's choice also through BatchEngine."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # one intra-op thread per test worker

from fastquick_tpu_torch import native  # noqa: E402
from fastquick_tpu_torch.align.engine import HostEngine, NativeEngine  # noqa: E402
from fastquick_tpu_torch.align.opts import GapOpt  # noqa: E402
from fastquick_tpu_torch.align.sample_setup import (  # noqa: E402
    exact_engine,
    index_options,
    sample_collector,
)
from fastquick_tpu_torch.bench import build_index  # noqa: E402
from fastquick_tpu_torch.ops.batch_search import BatchEngine  # noqa: E402
from fastquick_tpu_torch.stats.keyed_collector import KeyedStatCollector  # noqa: E402
from fastquick_tpu_torch.testing.synthworld import build_synth_pe_world  # noqa: E402

N_SIZE = 37  # the N count of the whole genome's .amb written below


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_sample_setup")
    w = build_synth_pe_world(tmp, n_markers=30, depth=1, seed=7)
    genome = "".join(line.strip() for line in open(w["ref_fa"])
                     if not line.startswith(">"))
    # the whole genome's bwa .amb: a header, then one line per N run
    with open(w["ref_fa"] + ".amb", "w") as fh:
        fh.write(f"{len(genome)} 1 2\n100 30 N\n900 7 N\n")
    bed = tmp / "target.bed"
    bed.write_text("".join(f"chr1\t{2500 * m - 200}\t{2500 * m + 80}\n"
                           for m in range(1, 31, 4)))
    return dict(w, new_ref=w["idx_prefix"] + ".FASTQuick.fa",
                genome_size=len(genome), bed=str(bed))


@pytest.mark.parametrize("which", ["index", "edited"])
def test_index_options_reads_the_param_file(world, tmp_path, which):
    """The four fields from the .param file, as the index wrote it and
    with every one of them away from GapOpt's default."""
    prefix = world["idx_prefix"]
    if which == "edited":
        prefix = str(tmp_path / "other")
        text = open(world["new_ref"] + ".param").read()
        for k, v in (("NUM_VAR_LONG", 3), ("NUM_VAR_SHORT", 7),
                     ("SHORT_FLANK_LENGTH", 111),
                     ("LONG_FLANK_LENGTH", 555)):
            text = "".join(f"{k}\t{v}\n" if ln.startswith(k + "\t") else ln
                           for ln in text.splitlines(keepends=True))
        with open(prefix + ".FASTQuick.fa.param", "w") as fh:
            fh.write(text)
    new_ref, opt, params = index_options(prefix)
    assert new_ref == prefix + ".FASTQuick.fa"
    fields = dict(line.rstrip("\n").split("\t")
                  for line in open(new_ref + ".param"))
    assert params == {k: int(v) if k.startswith(("NUM_", "SHORT_", "LONG_"))
                      else v for k, v in fields.items()}
    assert (opt.num_variant_long, opt.num_variant_short, opt.flank_len,
            opt.flank_long_len) == (
        int(fields["NUM_VAR_LONG"]), int(fields["NUM_VAR_SHORT"]),
        int(fields["SHORT_FLANK_LENGTH"]), int(fields["LONG_FLANK_LENGTH"]))
    if which == "edited":
        assert (opt.num_variant_long, opt.num_variant_short, opt.flank_len,
                opt.flank_long_len) == (3, 7, 111, 555)
    # every other field keeps GapOpt's default
    want = GapOpt()
    want.num_variant_long, want.num_variant_short = (opt.num_variant_long,
                                                     opt.num_variant_short)
    want.flank_len, want.flank_long_len = opt.flank_len, opt.flank_long_len
    assert opt == want


def _inline_collector(new_ref, opt, target, genome_size):
    """The collector align and merge built inline: the sites, the whole
    genome's size and N count, the target region when the index has one."""
    c = KeyedStatCollector()
    c.restore_vcf_sites(new_ref, opt)
    c.set_genome_size(genome_size, N_SIZE)
    if target != "Empty":
        c.set_target_region(target)
    return c


@pytest.mark.parametrize("case", ["no_params", "no_target", "target"])
def test_sample_collector_equals_the_inline_set_up(world, case):
    new_ref, opt, params = index_options(world["idx_prefix"])
    if case == "target":
        params = dict(params, TARGET_REGION_PATH=world["bed"])
    assert params["REFERENCE_PATH"] == world["ref_fa"]
    got = sample_collector(new_ref, opt,
                           None if case == "no_params" else params)
    if case == "no_params":  # the one-program step's: sites alone
        want = KeyedStatCollector()
        want.restore_vcf_sites(new_ref, opt)
        assert (got.ref_genome_size, got.ref_N_size) == (0, 0)
    else:
        want = _inline_collector(new_ref, opt, params["TARGET_REGION_PATH"],
                                 world["genome_size"])
        assert (got.ref_genome_size, got.ref_N_size) == (
            world["genome_size"], N_SIZE)
    assert got.target_region.regions == want.target_region.regions
    assert bool(got.target_region.regions) == (case == "target")
    assert got.flank_region.regions == want.flank_region.regions
    assert sum(map(len, got.flank_region.regions.values())) > 0
    for f in ("ref_genome_size", "ref_N_size", "num_short_marker",
              "num_long_marker", "num_xy_marker", "vcf_table",
              "dbsnp_table"):
        assert getattr(got, f) == getattr(want, f), f
    ws, gs = want.sites, got.sites
    assert gs.total == ws.total > 0
    for ch, d in ws.chroms.items():
        for k, v in d.items():
            np.testing.assert_array_equal(gs.chroms[ch][k], v,
                                          err_msg=f"{ch} {k}")


@pytest.fixture(scope="module")
def idx():
    return build_index(4096)


class _BrokenLib:
    """A native library whose set-up of the index fails."""

    def aln_create(self, *args):
        raise MemoryError("aln_create")


@pytest.mark.parametrize("via", ["exact_engine", "BatchEngine"])
@pytest.mark.parametrize("lib", ["built", "missing", "broken"])
def test_exact_engine_falls_back_only_without_the_library(idx, monkeypatch,
                                                          via, lib):
    """Native where its library loads, the Python oracle only where the
    library is missing (NativeEngine's RuntimeError); any other failure of
    the native engine's set-up raises, in BatchEngine too."""
    if lib == "built" and native.get_aligner_lib() is None:
        pytest.skip("needs the native aligner (g++)")
    if lib != "built":
        monkeypatch.setattr(native, "get_aligner_lib",
                            lambda: None if lib == "missing" else _BrokenLib())

    def make():
        return (exact_engine(idx) if via == "exact_engine"
                else BatchEngine(idx, "cpu").host)

    if lib == "broken":
        with pytest.raises(MemoryError, match="aln_create"):
            make()
    else:
        engine = make()
        assert type(engine) is (NativeEngine if lib == "built"
                                else HostEngine)
