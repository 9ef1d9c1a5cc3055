"""The port's ``align --device_qc --device cpu`` end to end against
fastquick_tpu's ``align`` on the synthetic paired-end world (~11.7k reads
with repeats, gapped reads, mismatches and junk): all 12 product files,
BAM included, must be byte-identical, with the default (resident) search
kernel and with the scan path (``FQ_BS_PALLAS=2``).  Without ``--device
cpu`` the port's ``align`` runs on CUDA and raises where there is none."""

import filecmp
import gzip
import json

import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread per test worker

from fastquick_tpu.testing.synthworld import build_synth_pe_world  # noqa: E402

ALL_OUTPUTS = ("Summary", "DepthDist", "GCDist", "EmpRepDist",
               "EmpCycleDist", "RawInsertSizeDist",
               "AdjustedInsertSizeDist", "SexChromInfo", "Pileup", "vcf",
               "InsertSizeTable", "bam")

# every span of one align call (fastquick_tpu_torch/utils/spans.py) and the
# span it nests in: None for the call itself and for the spans of the stats
# worker and the BAM writer
SPANS = {"call": None, "call.setup": "call", "io+filter": "call",
         "io.read": "io+filter", "kmer.upload": "io+filter",
         "kmer.filter": "io+filter", "search": "call",
         "search.redo_wait": "search", "pe": "call", "mate-sw": "call",
         "sw.device": "mate-sw", "refine": "call", "wait.prefetch": "call",
         "wait.stats": "call", "call.finish": "call", "stats+out": None,
         "bam.write": None}
# the main thread's spans directly inside `call`: they do not overlap
# (`io+filter` also counts the prefetch thread's reads, which overlap them)
MAIN_CHILDREN = [k for k, v in SPANS.items() if v == "call"]
# the spans that portbench's *_us_per_read.align readers have read since
# the port's first benchmark, under the same names
METERED = ("io+filter", "search", "pe", "mate-sw", "stats+out")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_e2e")
    w = build_synth_pe_world(tmp)
    assert w["n_reads"] >= 10000, w["n_reads"]
    return dict(tmp=tmp, args=["--fastq_1", w["fq1"], "--fastq_2", w["fq2"],
                               "--index_prefix", w["idx_prefix"]])


@pytest.fixture(scope="module")
def outputs(world):
    from fastquick_tpu.cli import main as jax_main
    from fastquick_tpu_torch.align import driver
    from fastquick_tpu_torch.cli import main as torch_main

    tmp = world["tmp"]
    assert jax_main(["align", *world["args"],
                     "--out_prefix", str(tmp / "ref")]) == 0
    assert torch_main(["align", *world["args"], "--out_prefix",
                       str(tmp / "port"), "--device_qc",
                       "--device", "cpu"]) == 0
    return tmp, dict(driver.LAST_RUN_STATS)


@pytest.mark.parametrize("sfx", ALL_OUTPUTS)
def test_product_file_byte_identical(outputs, sfx):
    tmp, _ = outputs
    ref, port = tmp / f"ref.{sfx}", tmp / f"port.{sfx}"
    assert ref.exists() and port.exists(), sfx
    assert filecmp.cmp(ref, port, shallow=False), sfx


@pytest.fixture(scope="module")
def scan_stats(world, outputs):
    """The same device run on the scan path (FQ_BS_PALLAS=2)."""
    from fastquick_tpu_torch.align import driver
    from fastquick_tpu_torch.cli import main as torch_main

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FQ_BS_PALLAS", "2")
        assert torch_main(["align", *world["args"], "--out_prefix",
                           str(world["tmp"] / "scan"), "--device_qc",
                           "--device", "cpu"]) == 0
    return dict(driver.LAST_RUN_STATS)


@pytest.mark.parametrize("sfx", ALL_OUTPUTS)
def test_scan_path_product_file_byte_identical(world, scan_stats, sfx):
    ref, scan = world["tmp"] / f"ref.{sfx}", world["tmp"] / f"scan.{sfx}"
    assert scan.exists(), sfx
    assert filecmp.cmp(ref, scan, shallow=False), sfx


def test_scan_path_ran(outputs, scan_stats):
    _, stats = outputs
    assert scan_stats["search_kernel"] == "scan"
    assert scan_stats["searched"] == stats["searched"]
    # every read takes one lane; 1,024 lanes need many refill rounds
    assert scan_stats["rounds"] > scan_stats["searched"] // 1024
    assert scan_stats["busy"] > 0
    assert sum(scan_stats["fb_causes"].values()) >= scan_stats["fallback"]


def test_device_path_ran(outputs):
    _, stats = outputs
    assert stats["engine"] == "device" and stats["device"] == "cpu"
    assert stats["search_kernel"] == "resident" and stats["rounds"] == 0
    assert stats["searched"] > 10000
    # the exact redo took only a small share, and every cause is named
    assert 0 <= stats["fallback"] < stats["searched"] // 4
    assert sum(stats["fb_causes"].values()) >= stats["fallback"]


def test_align_on_cuda_raises_without_cuda(world, monkeypatch):
    from fastquick_tpu_torch.cli import main as torch_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        torch_main(["align", *world["args"], "--out_prefix",
                    str(world["tmp"] / "nocuda"), "--device_qc"])
    assert not (world["tmp"] / "nocuda.bam").exists()


def test_stage_t_holds_every_span(outputs):
    _, stats = outputs
    st = stats["stage_t"]
    assert set(SPANS) <= set(st), set(SPANS) - set(st)
    assert set(METERED) <= set(st)
    assert "stats-enq" not in st
    assert all(v >= 0.0 for v in st.values())


def test_spans_nest_in_their_parents(outputs):
    _, stats = outputs
    st = stats["stage_t"]
    for child, parent in SPANS.items():
        if parent not in (None, "call"):
            assert st[child] <= st[parent], (child, parent)
    # the reader and the filter of every batch, inside the fetches
    assert st["io.read"] + st["kmer.upload"] + st["kmer.filter"] <= \
        st["io+filter"]
    assert st["io+filter"] <= st["call"]
    assert sum(st[k] for k in MAIN_CHILDREN if k != "io+filter") <= st["call"]


def test_run_stats_count_batches(world, outputs):
    _, stats = outputs
    with gzip.open(world["args"][1], "rt") as fh:
        n_reads = sum(1 for _ in fh) // 2
    # the world fits one read batch of 262,144 pairs
    assert stats["batches"] == 1
    assert 0 < stats["searched"] <= n_reads


# the traced align reads the world's first TRACED_PAIRS pairs with the
# resident search's step cap at TRACED_STEP_CAP (the exact host redo takes
# the reads it stops): the profiler records every torch op of the CPU
# search, ~5 M events at the default cap of 1,536 steps, ~0.7 M at 128
TRACED_PAIRS = 1000
TRACED_STEP_CAP = 128


@pytest.fixture(scope="module")
def traced(world):
    """The same align, on the world's first TRACED_PAIRS pairs, under a CPU
    torch.profiler session: the fq. events of its Chrome trace, as (name,
    thread, start, end) in us."""
    from fastquick_tpu_torch.cli import main as torch_main

    tmp = world["tmp"]
    args = list(world["args"])
    for flag in ("--fastq_1", "--fastq_2"):
        k = args.index(flag) + 1
        part = tmp / f"traced{flag[-1]}.fq"
        with gzip.open(args[k], "rt") as src, open(part, "w") as dst:
            for _, line in zip(range(4 * TRACED_PAIRS), src):
                dst.write(line)
        args[k] = str(part)
    with pytest.MonkeyPatch.context() as mp, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        mp.setenv("FQ_BS_STEPCAP", str(TRACED_STEP_CAP))
        assert torch_main(["align", *args, "--out_prefix",
                           str(tmp / "traced"), "--device_qc",
                           "--device", "cpu"]) == 0
    path = tmp / "traced.trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        ev = json.load(fh)["traceEvents"]
    path.unlink()
    return [(e["name"][3:], e["tid"], float(e["ts"]),
             float(e["ts"]) + float(e["dur"])) for e in ev
            if e.get("cat") == "user_annotation"
            and e.get("name", "").startswith("fq.")]


def test_traced_main_thread_spans_lie_inside_the_call(traced):
    calls = [e for e in traced if e[0] == "call"]
    assert len(calls) == 1
    _, tid, lo, hi = calls[0]
    main = [e for e in traced if e[1] == tid]
    assert {e[0] for e in main} >= {"call.setup", "io+filter", "search",
                                    "pe", "mate-sw", "refine",
                                    "wait.stats", "call.finish"}
    assert all(lo <= e[2] <= e[3] <= hi for e in main)
    kids = sorted(e[2:] for e in main if e[0] in MAIN_CHILDREN)
    for (_, end), (start, _) in zip(kids, kids[1:]):
        assert end <= start
    for name, _, start, end in main:
        parent = SPANS.get(name)
        if parent not in (None, "call"):
            assert any(p[0] == parent and p[2] <= start and end <= p[3]
                       for p in main), name
