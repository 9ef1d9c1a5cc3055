"""The port's ``align --device_qc --device cpu`` on a WGS-shaped sample
streamed through several read batches: the benchmark's ``align.wgs`` cell
at the tiny size (``portbench/tests/cases.tiny_cell``), with the driver's
read batch cut from 262,144 pairs to BATCH so that the sample spans four
batches, the last one ragged.  The prefetch of the next batch, the stats
worker's overlap, the insert-size carry-over and the device dense sums
across several batch flushes all run, behind a k-mer filter that drops
most reads.

The cell's own mix puts 0.3% of pairs on a flank: of PAIRS pairs that
leaves about a dozen, a few a batch, too few for any batch to estimate
the insert size (an estimate needs 20 pairs of two confident ends), so
the carry-over would have nothing to carry.  The test's copy of the mix
raises ``on_target`` to ON_TARGET: about sixty pairs on a flank in each
full batch, which estimates its own insert size, and two or so in the
ragged last batch of 40 pairs, which cannot and so takes the previous
batch's estimate (``last_ii``).  The benchmark's cell never takes that
copy: its last batch of 75,712 pairs holds ~230 pairs on a flank.

(a) the run is judged by ``portbench/reference`` with the cell's limits,
its batch count and search count agree with the FileStat, and the last
batch pairs with the carried estimate; (b) the same FASTQs through the
JAX package's ``align`` at the same batch size give all 12 product files
byte-identical."""

import filecmp
import os

import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread per test worker

from portbench import run  # noqa: E402

ALL_OUTPUTS = ("Summary", "DepthDist", "GCDist", "EmpRepDist",
               "EmpCycleDist", "RawInsertSizeDist",
               "AdjustedInsertSizeDist", "SexChromInfo", "Pileup", "vcf",
               "InsertSizeTable", "bam")
PAIRS = 4000
BATCH = 1320
BATCHES = 4  # 1,320 x 3 + 40
ON_TARGET = 0.05
SEED = 2**31 + 11


def _batch_size(monkeypatch, mapper_cls):
    """mapper_cls.run with its read batch cut to BATCH pairs."""
    orig = mapper_cls.run

    def run_small(self, fq1, fq2, fsc, batch_size=BATCH):
        return orig(self, fq1, fq2, fsc, batch_size)

    monkeypatch.setattr(mapper_cls, "run", run_small)


@pytest.fixture(scope="module")
def wgs(tmp_path_factory):
    """The tiny align.wgs cell set up and stepped once on the CPU: its
    driver, the step's LAST_RUN_STATS, the FileStat of the step and, a
    batch each, the insert size it estimated itself, the one it was given
    (``last_ii``) and the one it paired with."""
    from fastquick_tpu_torch.align import driver
    from fastquick_tpu_torch.stats.collector import StatCollector

    tmp = tmp_path_factory.mktemp("wgs")
    fscs, isize = [], []
    with pytest.MonkeyPatch.context() as mp:
        # cases.py lowers the plain search's step cap for its process on
        # import; held to this fixture, since the JAX package reads the
        # variable once, when it is imported, and other tests of this
        # worker compare the port's engine with the JAX package's
        mp.setenv("FQ_BS_STEPCAP", os.environ.get("FQ_BS_STEPCAP", "400"))
        from portbench.tests.cases import tiny_cell

        c = tiny_cell("align.wgs", pairs=PAIRS)
        c["mix"]["on_target"] = ON_TARGET
        mod = run.load_module(os.path.join(run.HERE, "drivers",
                                           c["cfg"]["driver"] + ".py"))
        _batch_size(mp, driver.PairEndMapper)
        orig_add = StatCollector.add_fsc

        def add_fsc(self, fsc):
            fscs.append(fsc)
            orig_add(self, fsc)

        mp.setattr(StatCollector, "add_fsc", add_fsc)
        orig_infer, orig_pair = driver.infer_isize, driver.PairEndMapper._pair
        own = []

        def infer_isize(pairs, ii, *args):
            out = orig_infer(pairs, ii, *args)
            own.append(ii.avg)
            return out

        def pair(self, b0, b1, last_ii):
            ii = orig_pair(self, b0, b1, last_ii)
            isize.append((own[-1], last_ii.avg, ii.avg))
            return ii

        mp.setattr(driver, "infer_isize", infer_isize)
        mp.setattr(driver.PairEndMapper, "_pair", pair)
        d = mod.Driver(c["cfg"], c["mix"], SEED, str(tmp), "cpu",
                       os.path.join(run.HERE, ".cache"))
        d.setup()
        d.step(0)
    stats = dict(driver.LAST_RUN_STATS)
    return dict(c=c, d=d, stats=stats, fsc=fscs[-1], tmp=tmp,
                isize=isize[-BATCHES:])


def test_wgs_sample_is_judged_correct(wgs):
    d, limits = wgs["d"], wgs["c"]["cfg"]["limits"]
    d.free()
    got, failed = d.judge(limits)
    assert failed == 0, got
    assert all(got[k] <= lim for k, lim in limits.items()), got
    # the sample reached search, pairing and the sums, not only the filter
    assert got["certain_reads"] > 0


def test_wgs_sample_spans_batches(wgs):
    st, fsc = wgs["stats"], wgs["fsc"]
    assert st["batches"] == BATCHES
    assert fsc.num_read == 2 * PAIRS
    # a filter that drops most pairs; the search saw only what it kept
    assert fsc.total_filtered > PAIRS // 2
    kept = PAIRS - fsc.total_filtered
    assert kept <= st["searched"] <= 2 * kept
    assert {"io.read", "kmer.filter"} <= set(st["stage_t"])


def test_wgs_last_batch_pairs_with_the_carried_insert_size(wgs):
    isize = wgs["isize"]
    assert len(isize) == BATCHES
    # the full batches estimate their own insert size and pair with it
    for k, (own, given, used) in enumerate(isize[:-1]):
        assert own > 0 and used == own, (k, isize)
        # each is handed on to the next batch
        assert isize[k + 1][1] == own, (k, isize)
    # the ragged last batch cannot, and pairs with the previous batch's
    own, given, used = isize[-1]
    assert own < 0 < given and used == given, isize


@pytest.fixture(scope="module")
def jax_ref(wgs):
    """The same FASTQs through the JAX package's align at BATCH pairs a
    batch: its output prefix."""
    import fastquick_tpu.align.driver as jax_driver
    from fastquick_tpu.cli import main as jax_main

    d, ref = wgs["d"], wgs["tmp"] / "ref"
    fq1, fq2 = d.fastqs[0]
    with pytest.MonkeyPatch.context() as mp:
        _batch_size(mp, jax_driver.PairEndMapper)
        assert jax_main(["align", "--fastq_1", fq1, "--fastq_2", fq2,
                         "--index_prefix", d.index, "--out_prefix",
                         str(ref)]) == 0
    return ref


@pytest.mark.parametrize("sfx", ALL_OUTPUTS)
def test_wgs_product_file_equals_the_jax_package(wgs, jax_ref, sfx):
    _, port = wgs["d"].runs[0]
    assert filecmp.cmp(f"{jax_ref}.{sfx}", f"{port}.{sfx}",
                       shallow=False), sfx
