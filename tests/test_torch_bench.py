"""The port's bench (fastquick_tpu_torch/bench.py) on the CPU against the
root bench.py and fastquick_tpu: the same world from the same seeds, the
JSON lines of the native (default) and cuda modes, the cuda mode's hits
against fastquick_tpu's native engine, the e2e mode's kept reads against
the host k-mer filter, and the default device raising where there is no
card.  The world is cut to 200 kbp and a few hundred reads; the step cap
is lowered so the plain search's passes stay short (the reads it cuts
off are redone exactly)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread per test worker

import bench as jbench  # noqa: E402
from fastquick_tpu.align.engine import NativeEngine  # noqa: E402
from fastquick_tpu.align.opts import GapOpt  # noqa: E402
from fastquick_tpu_torch import bench as tbench  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
N_BP, N_READS, L = 200_000, 256, 151
SMALL = {"FQ_BENCH_REF_BP": str(N_BP), "FQ_BENCH_READS": str(N_READS),
         "FQ_BENCH_STREAM": "2048", "FQ_BENCH_REPS": "1",
         "FQ_BS_STEPCAP": "400"}
# the root bench's default-mode line (no paired reference), and the keys of
# its TPU byte model, which the port does not carry over
ROOT_DEFAULT_KEYS = {
    "metric", "value", "unit", "vs_baseline", "baseline_reads_per_sec",
    "baseline_source", "tpu_reads_per_sec", "tpu_kernel", "tpu_iters",
    "tpu_fallback_reads", "tpu_fallback_causes", "tpu_busy_lane_frac",
    "tpu_bytes_per_iter", "tpu_achieved_GBps", "tpu_hbm_sol_frac",
    "tpu_traffic_domain", "e2e_reads_qc_per_sec_per_chip"}
TPU_MODEL = {"tpu_bytes_per_iter", "tpu_traffic_domain"}
PORT_DEFAULT_KEYS = ({k.replace("tpu_", "cuda_")
                      for k in ROOT_DEFAULT_KEYS - TPU_MODEL}
                     | {"cuda_bytes_moved", "cuda_launches", "e2e_kept",
                        "device"})
# the root bench's tpu-mode line, with tpu -> cuda
ROOT_CUDA_KEYS = ({k for k in ROOT_DEFAULT_KEYS if not k.startswith(
    ("tpu_", "e2e_"))} | {"engine", "kernel", "iters", "fallback_reads",
                          "fallback_causes", "busy_lane_frac",
                          "achieved_GBps", "hbm_sol_frac"})
PORT_CUDA_KEYS = ROOT_CUDA_KEYS | {"bytes_moved", "launches", "device"}


@pytest.fixture(scope="module")
def worlds():
    return (jbench.build_index(N_BP), tbench.build_index(N_BP))


def test_world_matches_root_bench(worlds):
    """The same seeds give the same text and the same reads, read for
    read, as the root bench's generator."""
    jidx, tidx = worlds
    np.testing.assert_array_equal(tidx.text, jidx.text)
    assert tidx.fm_fwd.primary == jidx.fm_fwd.primary
    for seed in (1, 7):
        want = jbench.make_reads(jidx, N_READS, L, seed=seed)
        got = tbench.make_reads(tidx, N_READS, L, seed=seed)
        for i, (w, g) in enumerate(zip(want, got)):
            assert (g.len, g.full_len, g.clip_len) == (w.len, w.full_len,
                                                       w.clip_len), i
            for f in ("seq", "rseq", "qual"):
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                              err_msg=f"read {i} {f}")


def _line(capsys) -> dict:
    out = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(out) == 1, out
    return json.loads(out[0])


@pytest.mark.parametrize("mode,keys", [("native", PORT_DEFAULT_KEYS),
                                       ("cuda", PORT_CUDA_KEYS)])
def test_mode_line_on_cpu(mode, keys, monkeypatch, capsys):
    """One JSON line with the root bench's keys (tpu_ -> cuda_) and the
    device; no device rate from a CPU run."""
    for k, v in dict(SMALL, FQ_BENCH_ENGINE=mode).items():
        monkeypatch.setenv(k, v)
    assert tbench.main(["--device", "cpu"]) == 0
    line = _line(capsys)
    assert set(line) == keys
    assert line["device"] == "cpu"
    assert line["baseline_source"] == "estimate"
    assert line["value"] > 0
    pre = "cuda_" if mode == "native" else ""
    assert line[pre + "kernel"] == "resident"
    assert line[pre + "hbm_sol_frac"] is None
    assert line[pre + "achieved_GBps"] is None
    assert line[pre + "bytes_moved"] > 0
    assert 0 < line[pre + "busy_lane_frac"] <= 1
    if mode == "native":
        assert line["cuda_reads_per_sec"] > 0
        assert 0 < line["e2e_kept"] < 2048


def test_cuda_mode_hits_match_jax_native(worlds, monkeypatch):
    """The cuda mode's engine, on the bench reads, against fastquick_tpu's
    native engine: every read's hit multiset equal, with some reads
    redone after the step cap and the rest from the search."""
    monkeypatch.setenv("FQ_BS_STEPCAP", "400")
    jidx, tidx = worlds
    jreads = jbench.make_reads(jidx, N_READS, L, seed=1)
    NativeEngine(jidx).align_batch(jreads, GapOpt())
    gold = tbench.hit_keys(jreads)
    reads = tbench.make_reads(tidx, N_READS, L, seed=1)
    r = tbench.run_cuda(tidx, reads, GapOpt(), torch.device("cpu"), 1, gold)
    assert r["ok"], f"read {r['first_mismatch']}"
    assert 0 < r["fallback_reads"] < N_READS // 4
    assert sum(1 for p in reads if p.aln) > N_READS // 2


def test_e2e_keeps_what_the_host_filter_keeps(worlds):
    """The e2e mode's device filter (plain PyTorch here) keeps exactly the
    reads of its 2,048-read stream that KmerFilter.is_read_kept keeps."""
    _, tidx = worlds
    r = tbench.run_e2e(tidx, 2048, L, torch.device("cpu"), reps=1)
    filt, seqs, lens = tbench.e2e_stream(tidx, 2048, L)
    want = [i for i in range(len(seqs)) if filt.is_read_kept(seqs[i])]
    assert r["survivors"].tolist() == want
    assert r["kept"] == len(want) and 0 < len(want) < 2048


@pytest.mark.parametrize("mode", ["native", "cuda", "e2e"])
def test_default_device_raises_without_cuda(mode):
    """With the default device on a host without a card every mode raises
    and the bench exits non-zero, printing no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, **SMALL, FQ_BENCH_ENGINE=mode)
    r = subprocess.run([sys.executable, "-m", "fastquick_tpu_torch.bench"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
    assert not r.stdout.strip()
