"""The port's DeviceDenseStats (plain PyTorch sums on the CPU) against
fastquick_tpu's jitted one: the same reads, made from a seed with numpy
over the index of the synthetic paired-end world, summed by both into
fresh collectors.  Depth, Q20, Q30 and the four empirical histograms must
be exactly equal."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread per test worker

from fastquick_tpu.align.device_qc import (  # noqa: E402
    DeviceDenseStats as JaxDenseStats,
)
from fastquick_tpu.align.opts import GapOpt as JaxGapOpt  # noqa: E402
from fastquick_tpu.index.builder import (  # noqa: E402
    load_index as jax_load_index,
    read_param,
)
from fastquick_tpu.stats.collector import (  # noqa: E402
    StatCollector as JaxCollector,
)
from fastquick_tpu.testing.synthworld import build_synth_pe_world  # noqa: E402
from fastquick_tpu_torch.align.device_qc import (  # noqa: E402
    DeviceDenseStats as TorchDenseStats,
)
from fastquick_tpu_torch.align.opts import GapOpt as TorchGapOpt  # noqa: E402
from fastquick_tpu_torch.index.builder import (  # noqa: E402
    load_index as torch_load_index,
)
from fastquick_tpu_torch.stats.collector import (  # noqa: E402
    StatCollector as TorchCollector,
)

ARRAYS = ("emp_rep_dist", "emp_cycle_dist", "mis_emp_rep_dist",
          "mis_emp_cycle_dist")


class _Read:
    def __init__(self, pos, strand, seq, qual):
        self.pos, self.strand, self.len = pos, strand, len(seq)
        self.seq, self.qual = seq, qual


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_dqc")
    w = build_synth_pe_world(tmp, n_markers=20, depth=4)
    return w["idx_prefix"] + ".FASTQuick.fa"


def _reads(text: np.ndarray, n: int, seed: int) -> list:
    """Reads over the reduced reference: mismatches, N codes, both
    strands, lengths 30..300 (the accumulation clips at 256 bases) and
    qualities across the Q20/Q30 tiers."""
    rng = np.random.default_rng(seed)
    out = []
    for r in range(n):
        ln = int(rng.integers(30, 301)) if r % 9 == 0 else 100
        pos = int(rng.integers(0, len(text) - ln))
        seq = text[pos:pos + ln].astype(np.uint8).copy()
        for _ in range(int(rng.binomial(ln, 0.03))):
            seq[int(rng.integers(0, ln))] = int(rng.integers(0, 5))
        strand = int(rng.integers(0, 2))
        if strand:  # as sequenced: the reverse complement
            seq = np.where(seq < 4, 3 - seq, 4)[::-1].astype(np.uint8)
        qual = (33 + rng.integers(2, 42, ln)).astype(np.uint8)
        out.append(_Read(pos, strand, seq, qual))
    return out


def _sums(pkg, new_ref, reads):
    load_index, GapOpt, Collector, Stats = pkg
    params = read_param(new_ref)
    opt = GapOpt()
    opt.flank_len = params["SHORT_FLANK_LENGTH"]
    opt.flank_long_len = params["LONG_FLANK_LENGTH"]
    idx = load_index(new_ref)
    coll = Collector()
    coll.restore_vcf_sites(new_ref, opt)
    stats = (Stats(idx, coll, opt, "cpu") if Stats is TorchDenseStats
             else Stats(idx, coll, opt))
    for p in reads:
        stats.add(p)
    stats.flush(coll)
    assert stats.reads_accumulated == len(reads)
    return idx, coll


@pytest.mark.parametrize("n_reads", [300, 4500])  # one and two batches
def test_dense_sums_match_jax(world, n_reads):
    text = jax_load_index(world).text
    reads = _reads(text, n_reads, seed=n_reads)
    _, want = _sums((jax_load_index, JaxGapOpt, JaxCollector, JaxDenseStats),
                    world, reads)
    _, got = _sums((torch_load_index, TorchGapOpt, TorchCollector,
                    TorchDenseStats), world, reads)
    assert want.sites.depth.sum() > 0, "reads should cover dense sites"
    assert want.mis_emp_rep_dist.sum() > 0, "reads should carry mismatches"
    for f in ("depth", "q20", "q30"):
        np.testing.assert_array_equal(getattr(got.sites, f),
                                      getattr(want.sites, f), err_msg=f)
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
