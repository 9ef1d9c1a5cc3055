"""The port's scan path (``FQ_BS_PALLAS=2``): its BatchEngine against
fastquick_tpu's scan-mode Pallas engine (interpret mode), its XLA lockstep
path and HostEngine; the plain scan path against search_plain at several
K_INNER and lane counts; the scan kernel's whole chunk (its round pieces
built for the host with g++, rounds, flushes and refills emulated lane by
lane) against the plain version; and the kernel selection.  Every
comparison is exact."""

import ctypes
import dataclasses
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread per test worker

from fastquick_tpu.align.engine import HostEngine  # noqa: E402
from fastquick_tpu.align.opts import GapOpt  # noqa: E402
from fastquick_tpu.ops import batch_search as jbs  # noqa: E402
from fastquick_tpu_torch.ops import batch_search as tbs  # noqa: E402
from fastquick_tpu_torch.ops import search_kernels as tsk  # noqa: E402
from fastquick_tpu_torch.ops.search_kernels import (  # noqa: E402
    PlainLanes,
    scan_search,
    search_plain,
)

from test_batch_engine import aln_key, make_idx, synth_reads  # noqa: E402
from test_search_pallas import pallas_engine  # noqa: E402
from test_torch_search import port_idx, port_reads  # noqa: E402


def keys(reads):
    return [[aln_key(a) for a in p.aln] for p in reads]


def test_matches_pallas_scan_and_host():
    """(a) The world of tests/test_search_pallas.py: port scan engine vs
    the reference's scan-mode Pallas engine and the host oracle."""
    seed = 0
    idx = make_idx(seed=seed)
    reads_h = synth_reads(idx, 60, seed + 10)
    reads_p = synth_reads(idx, 60, seed + 10)
    reads_t = port_reads(synth_reads(idx, 60, seed + 10))
    HostEngine(idx).align_batch(reads_h, GapOpt())
    ep = pallas_engine(idx, mode="scan", max_batch=64, pool=512,
                       step_cap=768)
    ep.align_batch(reads_p, GapOpt())
    et = tbs.BatchEngine(port_idx(idx), "cpu", pallas="scan", pool=512,
                         step_cap=768)
    assert et.kernel == "scan"
    et.align_batch(reads_t, GapOpt())
    assert et.last_fallback == ep.last_fallback
    assert et.last_fb_causes == ep.last_fb_causes
    assert et.last_iters == ep.last_iters > 0
    assert keys(reads_t) == keys(reads_p)
    assert keys(reads_t) == keys(reads_h)


def test_matches_xla_lockstep_with_refill():
    """(b) ~500 reads on 128 lanes, so lanes flush and refill many times:
    hits, fallbacks, rounds (last_iters) and busy steps must equal the
    reference's XLA lockstep path."""
    idx = make_idx(seed=4)
    reads_x = synth_reads(idx, 500, 44)
    reads_t = port_reads(synth_reads(idx, 500, 44))
    ex = jbs.BatchEngine(idx, lanes=128, pallas=False)
    ex.align_batch(reads_x, GapOpt())
    et = tbs.BatchEngine(port_idx(idx), "cpu", lanes=128, pallas="scan")
    et.align_batch(reads_t, GapOpt())
    assert (et.pool, et.inner) == (ex.pool, ex.inner) == (512, 32)
    assert et.last_fallback == ex.last_fallback
    assert et.last_fb_causes == ex.last_fb_causes
    assert et.last_iters == ex.last_iters
    assert et.last_busy == ex.last_busy
    assert keys(reads_t) == keys(reads_x)


def _chunk(seed=3, n_reads=150, pool=256, step_cap=400):
    """Scan-path inputs of one chunk, as BatchEngine builds them; a tight
    pool and cap exercise the fallbacks too."""
    idx = make_idx(seed=seed)
    reads = port_reads(synth_reads(idx, n_reads, 10 * seed + 3))
    eng = tbs.BatchEngine(port_idx(idx), "cpu", pool=pool, pallas="scan")
    packed, aux, P = tbs.pack_chunk(reads, GapOpt(), pool, kernel="scan")
    P = dataclasses.replace(P, step_cap=step_cap)
    inp = tbs.chunk_inputs(eng.dev, torch.from_numpy(packed),
                           torch.from_numpy(aux), P)
    return eng.dev, P, inp


@pytest.mark.parametrize("lanes", [64, 256])
@pytest.mark.parametrize("inner", [1, 7, 32])
def test_scan_plain_matches_search_plain(inner, lanes):
    """(c) The plain scan path gives every read search_plain's result,
    whatever the lanes and the steps between flushes."""
    fm, P, inp = _chunk()
    want = search_plain(fm, P, **inp)
    got = scan_search(fm, P, PlainLanes(fm, P, lanes, **inp), inner)
    for name, a, b in zip(("n_aln", "alns", "fb", "steps"), got, want):
        assert torch.equal(a, b), name
    assert int((want[2] != 0).sum()) > 0, "world should exercise fallbacks"
    # busy counts the steps of every flushed read
    assert int(got[5]) == int(want[3].long().sum())


def _host_scan(fm, P, inp, lanes, inner):
    """The scan kernel's whole chunk on min(lanes, N) lanes, built with g++
    (fq_scan_host): (n_aln, alns, fb, steps, rounds, busy)."""
    from fastquick_tpu_torch.kernels.build import host_library

    i32 = torch.int32
    N = inp["seqs0"].shape[0]
    seqs8 = inp["seqs0"].to(torch.uint8).contiguous()
    cols = [inp[k].to(i32).contiguous()
            for k in ("lens", "md", "use_seed", "n_n")]
    widths = inp["widths"].clone()
    seed_w = inp["seed_w"].to(i32).contiguous()
    alns = torch.zeros((N, tsk.A_MAX, 3), dtype=i32)
    n_aln, fb, steps = (torch.zeros(N, dtype=i32) for _ in range(3))
    stats = torch.zeros(2, dtype=torch.long)
    hp = fm.host_params()
    sp = P.to_array()

    def p(t):
        return ctypes.c_void_p(t.data_ptr())

    assert host_library().fq_scan_host(
        p(fm.kernel_table()), hp.ctypes.data_as(ctypes.c_void_p),
        sp.ctypes.data_as(ctypes.c_void_p), p(seqs8), *map(p, cols), N,
        p(widths), p(seed_w), p(alns), p(n_aln), p(fb), p(steps),
        min(lanes, N), inner, tsk._n_ids(inp["md"]), p(stats)) == 0
    return n_aln, alns, fb, steps, int(stats[0]), int(stats[1])


def _same_scan(got, want):
    for name, a, b in zip(("n_aln", "alns", "fb", "steps"), got, want):
        assert torch.equal(a, b), name
    assert (got[4], int(got[5])) == (want[4], int(want[5])), "rounds, busy"


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
@pytest.mark.parametrize("lanes", [64, 256])
@pytest.mark.parametrize("inner", [1, 32])
def test_scan_body_host_build_matches_plain(inner, lanes):
    """(d) The scan kernel's whole chunk (fq_scan_advance / flush / refill,
    the lane record carried across rounds, the refill ids numbered in lane
    order) built with g++ against the plain scan path: hits, fallbacks,
    steps, rounds and busy steps."""
    fm, P, inp = _chunk(seed=2, n_reads=200, pool=512, step_cap=768)
    want = scan_search(fm, P, PlainLanes(fm, P, lanes, **inp), inner)
    _same_scan(_host_scan(fm, P, inp, lanes, inner), want)
    assert int(want[0].sum()) > 0 and int((want[2] != 0).sum()) > 0
    assert want[4] > 1


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
def test_scan_host_build_more_lanes_than_reads():
    """A chunk of N = 256 rows (3 reads) asked for 512 lanes runs on N
    lanes, in the host build and in scan_chunk's plain version alike."""
    fm, P, inp = _chunk(seed=5, n_reads=3, pool=512, step_cap=768)
    N = inp["seqs0"].shape[0]
    want = scan_search(fm, P, PlainLanes(fm, P, N, **inp), 4)
    _same_scan(_host_scan(fm, P, inp, 2 * N, 4), want)
    _same_scan(tsk.scan_chunk(fm, P, 2 * N, 4, **inp), want)
    assert want[4] > 0


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
def test_scan_host_build_padding_heavy_chunk():
    """The world of ROADMAP section C: 120 reads padded to 256 rows on 128
    lanes, where the padding rows outnumber the lanes and the reference's
    outer round never ends.  The host build ends with the plain loop's
    rounds and busy steps."""
    idx = make_idx(seed=4)
    reads = port_reads(synth_reads(idx, 120, 44))
    eng = tbs.BatchEngine(port_idx(idx), "cpu", lanes=128, pallas="scan")
    packed, aux, P = tbs.pack_chunk(reads, GapOpt(), eng.pool,
                                    kernel="scan")
    assert packed.shape[0] - len(reads) > eng.lanes
    inp = tbs.chunk_inputs(eng.dev, torch.from_numpy(packed),
                           torch.from_numpy(aux), P)
    want = scan_search(eng.dev, P, PlainLanes(eng.dev, P, 128, **inp), 32)
    _same_scan(_host_scan(eng.dev, P, inp, 128, 32), want)
    assert int(want[5]) == int(want[3].long().sum()) > 0


def test_kernel_selection(monkeypatch):
    """(e) FQ_BS_PALLAS=0 (the reference's XLA lockstep path) raises on a
    CUDA request before anything moves to the device; 1 and 2 pick the
    resident and scan kernels; on the CPU 0 runs the scan path's plain
    version."""
    sk = tbs.search_kernel
    assert sk("cuda", 1) == "resident" and sk("cuda", 2) == "scan"
    assert sk("cuda", True) == "scan" and sk("cpu", 0) == "scan"
    with pytest.raises(RuntimeError, match="not ported"):
        sk("cuda", 0)
    with pytest.raises(ValueError):
        sk("cuda", 3)
    monkeypatch.delenv("FQ_BS_PALLAS", raising=False)
    assert sk("cuda") == "resident"
    monkeypatch.setenv("FQ_BS_PALLAS", "2")
    assert sk("cuda") == "scan"
    monkeypatch.setenv("FQ_BS_PALLAS", "0")
    idx = port_idx(make_idx(seed=1))
    with pytest.raises(RuntimeError, match="not ported"):
        tbs.BatchEngine(idx, "cuda")
    eng = tbs.BatchEngine(idx, "cpu")
    assert (eng.kernel, eng.pool) == ("scan", 512)


def test_engine_knobs_from_environment(monkeypatch):
    """FQ_BS_LANES / INNER / POOL / STEPCAP are read when the engine is
    made, with the reference's per-kernel auto pool."""
    idx = port_idx(make_idx(seed=1))
    for k in ("FQ_BS_LANES", "FQ_BS_INNER", "FQ_BS_POOL", "FQ_BS_STEPCAP",
              "FQ_BS_PALLAS"):
        monkeypatch.delenv(k, raising=False)
    e = tbs.BatchEngine(idx, "cpu")
    assert (e.kernel, e.lanes, e.inner, e.pool, e.step_cap) == (
        "resident", 1024, 32, 1024, 0)
    monkeypatch.setenv("FQ_BS_PALLAS", "2")
    monkeypatch.setenv("FQ_BS_LANES", "256")
    monkeypatch.setenv("FQ_BS_INNER", "8")
    monkeypatch.setenv("FQ_BS_STEPCAP", "900")
    e = tbs.BatchEngine(idx, "cpu")
    assert (e.kernel, e.lanes, e.inner, e.pool, e.step_cap) == (
        "scan", 256, 8, 512, 900)
    monkeypatch.setenv("FQ_BS_POOL", "300")
    assert tbs.BatchEngine(idx, "cpu").pool == 300
    reads = port_reads(synth_reads(make_idx(seed=1), 4, 1, read_len=300))
    # auto caps at Lpad 320: max(768, 3 Lpad) for scan, max(1536, 6 Lpad)
    _, _, P = tbs.pack_chunk(reads, GapOpt(), 512, kernel="scan")
    assert P.step_cap == 960
    _, _, P = tbs.pack_chunk(reads, GapOpt(), 512)
    assert P.step_cap == 1920


def test_padding_lanes_stay_idle():
    """A chunk of 3 reads padded to 256 rows on 256 lanes: the padding
    rows' lanes go idle at once and the reads' lanes run to the end in the
    same rounds as on 3 lanes.  On 3 lanes the 253 padding rows outnumber
    the lanes, where the reference's outer round would never end."""
    fm, P, inp = _chunk(seed=5, n_reads=3, pool=512, step_cap=768)
    many = scan_search(fm, P, PlainLanes(fm, P, 256, **inp), 4)
    few = scan_search(fm, P, PlainLanes(fm, P, 3, **inp), 4)
    for a, b in zip(many[:4], few[:4]):
        assert torch.equal(a, b)
    assert many[4] == few[4] > 0
    assert int(many[3][3:].abs().sum()) == 0
    np.testing.assert_array_equal(many[0][:3].numpy() > 0, [True] * 3)
