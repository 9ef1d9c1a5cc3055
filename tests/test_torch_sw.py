"""The port's Smith-Waterman forward pass (plain PyTorch on the CPU)
against fastquick_tpu's numpy spec and the Pallas SW kernel (interpret
mode); the port's mate-rescue glue against align/dp.local_align; the SW
kernel's wavefront, built for the host with g++, against the plain
version; an edge batch against the spec; and the mate-rescue route,
which takes the device only in device-QC mode.  Every comparison is
exact."""

import ctypes
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread per test worker

from fastquick_tpu.ops.sw_pallas import (  # noqa: E402
    sw_forward_batch as jax_sw_forward_batch,
    sw_forward_reference,
)
from fastquick_tpu_torch.ops.sw_kernels import (  # noqa: E402
    sw_forward_batch,
    sw_forward_plain,
)

from test_sw_pallas import QL, RL, _cases  # noqa: E402


def _port_forward(refs, queries, rlens, qlens) -> np.ndarray:
    return sw_forward_batch(*[torch.from_numpy(a) for a in
                              (refs, queries, rlens, qlens)]).numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_reference(seed):
    refs, queries, rlens, qlens = _cases(seed, 24)
    out = _port_forward(refs, queries, rlens, qlens)
    for b in range(len(refs)):
        want = sw_forward_reference(refs[b, :rlens[b]], queries[b, :qlens[b]])
        got = (int(out[b, 0]), int(out[b, 1]), int(out[b, 2]))
        assert got == want, f"case {b}: {got} vs {want}"
        assert out[b, 3] == 0


def test_forward_matches_pallas_kernel():
    refs, queries, rlens, qlens = _cases(3, 16)
    want = np.asarray(jax_sw_forward_batch(
        jnp.asarray(refs), jnp.asarray(queries), jnp.asarray(rlens),
        jnp.asarray(qlens), RL=RL, QL=QL))
    np.testing.assert_array_equal(
        _port_forward(refs, queries, rlens, qlens), want)


def _rescue_jobs(seed, n):
    """The mate-rescue jobs of tests/test_sw_pallas.py: embedded reads with
    mismatches, deletions, insertions, and junk."""
    rng = np.random.default_rng(seed)
    jobs = []
    for t in range(n):
        rl = int(rng.integers(60, 500))
        ql = int(rng.integers(20, 120))
        ref = rng.integers(0, 4, rl).astype(np.uint8)
        q = ref[int(rng.integers(0, max(1, rl - ql))):][:ql].copy()
        kind = t % 5
        if kind == 1:
            for _ in range(rng.binomial(len(q), 0.06)):
                p = int(rng.integers(0, len(q)))
                q[p] = (q[p] + rng.integers(1, 4)) % 4
        elif kind == 2:
            m = len(q) // 2
            q = np.concatenate([q[:m], q[m + 2:]])
        elif kind == 3:
            m = len(q) // 2
            q = np.concatenate(
                [q[:m], rng.integers(0, 4, 2).astype(np.uint8), q[m:]])
        elif kind == 4:
            q = rng.integers(0, 4, ql).astype(np.uint8)
        jobs.append((ref, q))
    return jobs


def test_sw_local_batch_device_matches_local_align():
    from fastquick_tpu.align.dp import local_align
    from fastquick_tpu_torch.ops.sw_kernels import sw_local_batch_device

    jobs = _rescue_jobs(21, 40)
    got = sw_local_batch_device(jobs, "cpu")
    for i, (ref, q) in enumerate(jobs):
        score, cigar, coords = local_align(ref, q, thres=1)
        g_score, g_cigar, g_coords = got[i]
        if score < 1 or not cigar:
            assert not g_cigar, f"job {i}"
            continue
        assert g_score == score, f"job {i}: {g_score} vs {score}"
        assert g_cigar == cigar, f"job {i}: {g_cigar} vs {cigar}"
        assert g_coords == coords, f"job {i}: {g_coords} vs {coords}"


def _host_forward(refs, queries, rlens, qlens) -> torch.Tensor:
    """The g++ build of the SW kernel's wavefront (fq_sw_host)."""
    from fastquick_tpu_torch.kernels.build import host_library

    B, RL = refs.shape
    QL = queries.shape[1]
    args = [torch.from_numpy(np.ascontiguousarray(a, dtype=d)) for a, d in
            ((refs, np.uint8), (queries, np.uint8), (rlens, np.int32),
             (qlens, np.int32))]
    out = torch.zeros((B, 4), dtype=torch.int32)

    def p(t):
        return ctypes.c_void_p(t.data_ptr())

    assert host_library().fq_sw_host(*[p(a) for a in args], B, RL, QL,
                                     p(out)) == 0
    return out


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
@pytest.mark.parametrize("seed", [0, 1])
def test_sw_body_host_build_matches_plain(seed):
    """The kernel's order of evaluation (strips, wavefront steps, lanes,
    column buffer, warp reduction), emulated by its g++ build."""
    refs, queries, rlens, qlens = _cases(seed, 24)
    want = sw_forward_plain(*[torch.from_numpy(a) for a in
                              (refs, queries, rlens, qlens)])
    assert torch.equal(_host_forward(refs, queries, rlens, qlens), want)


@pytest.mark.parametrize("impl", ["plain", "host_build"])
def test_sw_edge_batch(impl):
    """Query lengths around the strip of 32, empty and one-base refs,
    all-N sequences and best scores reached in several cells, against the
    reference's numpy spec."""
    from fastquick_tpu_torch.testing.sw_cases import sw_edge_batch

    if impl == "host_build" and shutil.which("g++") is None:
        pytest.skip("needs g++")
    refs, queries, rlens, qlens = sw_edge_batch(0)
    if impl == "plain":
        out = _port_forward(refs, queries, rlens, qlens)
    else:
        out = _host_forward(refs, queries, rlens, qlens).numpy()
    for b in range(len(refs)):
        want = sw_forward_reference(refs[b, :rlens[b]].astype(np.int32),
                                    queries[b, :qlens[b]].astype(np.int32))
        got = (int(out[b, 0]), int(out[b, 1]), int(out[b, 2]))
        assert got == want, f"job {b} (rl {rlens[b]}, ql {qlens[b]})"
        assert out[b, 3] == 0


def test_device_sw_default_on_in_device_mode(monkeypatch):
    """As in fastquick_tpu: with device_sw (the driver's device-QC mode)
    the mate-rescue jobs go to the SW kernel on the device the driver
    chose; without it they stay off the device."""
    from fastquick_tpu_torch.align import pe
    from fastquick_tpu_torch.ops import sw_kernels

    calls = []
    monkeypatch.setattr(
        sw_kernels, "sw_local_batch_device",
        lambda jobs, device: calls.append((len(jobs), device))
        or [None] * len(jobs))
    text = np.random.default_rng(0).integers(0, 4, 500).astype(np.uint8)

    class _R:
        len = 40

    todo = [(([_R(), _R()]), [(100, 200, text[100:140].copy()), None])]
    pe._batch_local_sw(text, todo, "cpu", device_sw=True)
    assert calls == [(1, "cpu")], calls

    calls.clear()
    pe._batch_local_sw(text, todo, "cpu", device_sw=False)
    pe._batch_local_sw(text, todo, "cpu")
    assert not calls, "the device kernel is taken only with device_sw"


@pytest.fixture(scope="module")
def small_world(tmp_path_factory):
    from fastquick_tpu_torch.testing.synthworld import build_synth_pe_world

    return build_synth_pe_world(tmp_path_factory.mktemp("torch_sw_route"),
                                n_markers=12, depth=5)


@pytest.mark.parametrize("mode,device_route",
                         [(["--device_qc"], True),
                          (["--engine", "native"], False)])
def test_align_rescues_on_the_device_only_in_device_qc_mode(
        small_world, tmp_path, monkeypatch, mode, device_route):
    """A CPU align takes the SW kernel's route (its plain version on
    --device cpu) for mate rescue in device-QC mode and the threaded
    native sw_local_batch in any other."""
    from fastquick_tpu_torch.cli import main
    from fastquick_tpu_torch.ops import sw_kernels

    monkeypatch.setenv("FQ_BS_STEPCAP", "400")  # a short plain search
    calls = []
    device_sw = sw_kernels.sw_local_batch_device

    def recorded(jobs, device):
        calls.append((len(jobs), device))
        return device_sw(jobs, device)

    monkeypatch.setattr(sw_kernels, "sw_local_batch_device", recorded)
    w = small_world
    assert main(["align", "--fastq_1", w["fq1"], "--fastq_2", w["fq2"],
                 "--index_prefix", w["idx_prefix"], "--out_prefix",
                 str(tmp_path / "out"), "--device", "cpu", *mode]) == 0
    if device_route:
        assert calls and all(d == "cpu" for _, d in calls), calls
        assert sum(n for n, _ in calls) > 0, calls
    else:
        assert not calls, calls
