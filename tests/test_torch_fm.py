"""The port's FM primitives (plain PyTorch) against fastquick_tpu.ops.fm,
on the worlds of tests/test_ops_fm.py; exact integer equality."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread per test worker

from fastquick_tpu.index.fmindex import FMIndex  # noqa: E402
from fastquick_tpu.ops import fm as jfm  # noqa: E402
from fastquick_tpu_torch.ops import fm as tfm  # noqa: E402


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    text = rng.integers(0, 4, 5000).astype(np.uint8)
    fm_f = FMIndex.build(text)
    fm_r = FMIndex.build(text[::-1].copy())
    jdev = jfm.DeviceFM.build(fm_f, fm_r)
    tdev = tfm.DeviceFM.from_numpy(
        np.asarray(jdev.words), np.asarray(jdev.occ), np.asarray(jdev.sa),
        np.asarray(jdev.L2), np.asarray(jdev.primary), jdev.n, "cpu")
    return text, fm_f, fm_r, jdev, tdev


def test_from_numpy_matches_build(world):
    text, fm_f, fm_r, jdev, tdev = world
    built = tfm.DeviceFM.build(fm_f, fm_r, "cpu")
    for name in ("words", "occ", "sa", "L2", "primary"):
        assert torch.equal(getattr(built, name), getattr(tdev, name)), name
    assert built.n == tdev.n == jdev.n
    # uint32 words are viewed, not converted: same bit pattern
    np.testing.assert_array_equal(
        built.words.numpy().view(np.uint32), np.asarray(jdev.words))


def test_from_numpy_shares_cpu_memory():
    words = np.arange(2 * 3 * 8, dtype=np.uint32).reshape(2, 3, 8)
    occ = np.zeros((2, 3, 4), np.int32)
    fm = tfm.DeviceFM.from_numpy(words, occ, np.zeros((2, 5), np.int32),
                                 np.zeros((2, 4), np.int32),
                                 np.zeros(2, np.int32), 4, "cpu")
    assert np.shares_memory(fm.words.numpy(), words)
    assert np.shares_memory(fm.occ.numpy(), occ)


def test_popcount32():
    rng = np.random.default_rng(9)
    x = rng.integers(0, 2**32, 1000, dtype=np.uint64)
    got = tfm.popcount32(torch.from_numpy(x.astype(np.int64))).numpy()
    want = np.array([bin(int(v)).count("1") for v in x])
    np.testing.assert_array_equal(got, want)


def test_occ4_matches_jax(world):
    _, fm_f, _, jdev, tdev = world
    rng = np.random.default_rng(1)
    ks = rng.integers(-1, fm_f.n + 1, 512).astype(np.int32)
    ks[:4] = [-1, 0, fm_f.n, fm_f.primary]
    sels = rng.integers(0, 2, 512).astype(np.int32)
    want = np.asarray(jfm.occ4(jdev, jnp.asarray(sels), jnp.asarray(ks)))
    got = tfm.occ4(tdev, torch.from_numpy(sels), torch.from_numpy(ks))
    np.testing.assert_array_equal(got.numpy(), want)


def test_backward_ext_matches_jax(world):
    _, fm_f, _, jdev, tdev = world
    rng = np.random.default_rng(2)
    B = 400
    k = rng.integers(0, fm_f.n + 1, B).astype(np.int32)
    l = np.minimum(k + rng.integers(0, 50, B), fm_f.n).astype(np.int32)
    sel = rng.integers(0, 2, B).astype(np.int32)
    c = rng.integers(0, 4, B).astype(np.int32)
    wk, wl = jfm.backward_ext(jdev, jnp.asarray(sel), jnp.asarray(k),
                              jnp.asarray(l), jnp.asarray(c))
    gk, gl = tfm.backward_ext(tdev, torch.from_numpy(sel),
                              torch.from_numpy(k), torch.from_numpy(l),
                              torch.from_numpy(c))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


@pytest.mark.parametrize("per_row_sel", [False, True])
def test_cal_width_matches_jax(world, per_row_sel):
    text, _, _, jdev, tdev = world
    rng = np.random.default_rng(3)
    B, L = 24, 64
    seqs = rng.integers(0, 4, (B, L)).astype(np.uint8)
    for b in range(0, B, 2):  # half the rows from the text
        s = int(rng.integers(0, len(text) - L))
        seqs[b] = text[s:s + L]
    seqs[0, 10] = 4
    seqs[5, 0] = 4
    lens = np.full(B, L, dtype=np.int32)
    lens[1], lens[3] = 40, 1
    sel = (np.arange(B) % 2).astype(np.int32) if per_row_sel else 0
    want = np.asarray(jfm.cal_width(jdev, jnp.asarray(sel), jnp.asarray(seqs),
                                    jnp.asarray(lens)))
    tsel = torch.from_numpy(sel) if per_row_sel else 0
    got = tfm.cal_width(tdev, tsel, torch.from_numpy(seqs),
                        torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), want)


def test_match_exact_matches_jax(world):
    text, _, _, jdev, tdev = world
    rng = np.random.default_rng(4)
    B, L = 32, 50
    seqs = np.zeros((B, L), dtype=np.uint8)
    lens = np.full(B, L, dtype=np.int32)
    for b in range(B):
        s = int(rng.integers(0, len(text) - L))
        seqs[b] = text[s:s + L]
    seqs[5] = rng.integers(0, 4, L)  # junk
    seqs[6, 20] = 4  # an N
    lens[7] = 30
    for sel in (0, 1):
        wk, wl = jfm.match_exact(jdev, sel, jnp.asarray(seqs),
                                 jnp.asarray(lens))
        gk, gl = tfm.match_exact(tdev, sel, torch.from_numpy(seqs),
                                 torch.from_numpy(lens))
        np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
