"""The port's width path against fastquick_tpu's cal_width and the Pallas
width kernel (interpret mode), on the 300 x 40 world of
tests/test_search_pallas.py; and the width kernel's per-unit body, built
for the host with g++, against the plain version, on that world and on
the edge batches of testing/width_cases.py."""

import ctypes
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread per test worker

from fastquick_tpu.index.fmindex import FMIndex  # noqa: E402
from fastquick_tpu.ops import fm as jfm  # noqa: E402
from fastquick_tpu_torch.ops import fm as tfm  # noqa: E402
from fastquick_tpu_torch.ops.search_kernels import width  # noqa: E402
from fastquick_tpu_torch.testing.width_cases import (  # noqa: E402
    EDGE_LENS,
    width_edge_batch,
)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(5)
    text = rng.integers(0, 4, 20000).astype(np.uint8)
    fmf = FMIndex.build(text)
    fmr = FMIndex.build(text[::-1].copy())
    M, L = 300, 40
    units = np.full((M, L), 4, np.int32)
    lens = np.zeros(M, np.int32)
    for i in range(M):
        ln = int(rng.integers(1, L + 1))
        s = int(rng.integers(0, len(text) - ln))
        codes = text[s:s + ln].astype(np.int32)
        for _ in range(int(rng.binomial(ln, 0.08))):
            codes[int(rng.integers(0, ln))] = int(rng.integers(0, 5))
        units[i, :ln] = codes
        lens[i] = ln
    sel = (np.arange(M) % 2).astype(np.int32)
    return dict(jdev=jfm.DeviceFM.build(fmf, fmr),
                tdev=tfm.DeviceFM.build(fmf, fmr, "cpu"), units=units,
                lens=lens, sel=sel, text=text)


def _port_width(w):
    wv, bv = width(w["tdev"], torch.from_numpy(w["units"]),
                   torch.from_numpy(w["sel"]))
    return tfm.width_finalize(wv, bv, torch.from_numpy(w["lens"])).numpy()


def test_width_matches_cal_width(world):
    w = world
    want = np.asarray(jfm.cal_width(w["jdev"], jnp.asarray(w["sel"]),
                                    jnp.asarray(w["units"]),
                                    jnp.asarray(w["lens"])))
    np.testing.assert_array_equal(_port_width(w), want)


def test_width_matches_width_pallas(world):
    from fastquick_tpu.ops.search_pallas import pack_fm_table, width_pallas

    w = world
    tab, nbp = pack_fm_table(w["jdev"])
    wv, bv = width_pallas(jnp.asarray(tab), w["jdev"].L2, w["jdev"].primary,
                          jnp.asarray(w["units"]), jnp.asarray(w["sel"]),
                          NBP=nbp, n=w["jdev"].n, WB=256)
    want = np.asarray(jfm.width_finalize(wv, bv, jnp.asarray(w["lens"])))
    np.testing.assert_array_equal(_port_width(w), want)


def _host_width(fm, units, sel):
    """The width kernel's body (width_unit) built with g++: (w, bid)."""
    from fastquick_tpu_torch.kernels.build import host_library

    M, L = units.shape
    wv = torch.zeros((M, L), dtype=torch.int32)
    bv = torch.zeros_like(wv)
    hp = fm.host_params()

    def p(t):
        return ctypes.c_void_p(t.data_ptr())

    assert host_library().fq_width_host(
        p(fm.kernel_table()), hp.ctypes.data_as(ctypes.c_void_p), p(units),
        p(sel), M, L, p(wv), p(bv)) == 0
    return wv, bv


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
def test_width_body_host_build_matches_plain(world):
    w = world
    fm = w["tdev"]
    units = torch.from_numpy(w["units"].astype(np.uint8))
    sel = torch.from_numpy(w["sel"])
    wv, bv = _host_width(fm, units, sel)
    want_w, want_b = tfm.cal_width_planes(fm, sel, units)
    assert torch.equal(wv, want_w) and torch.equal(bv, want_b)


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
@pytest.mark.parametrize("L", EDGE_LENS)
def test_width_body_host_build_edges(world, L):
    """Unit lengths around the kernel's tile of 32 positions, 300 units (not
    a multiple of its block of 128): all-N units, random codes, units that
    follow the text, with errors, and units whose interval holds the
    primary row."""
    fm = world["tdev"]
    units_np, sel_np = width_edge_batch(world["text"], L, seed=L)
    units, sel = torch.from_numpy(units_np), torch.from_numpy(sel_np)
    wv, bv = _host_width(fm, units, sel)
    want_w, want_b = tfm.cal_width_planes(fm, sel, units)
    assert torch.equal(wv, want_w) and torch.equal(bv, want_b)
    # random codes restart buckets within the unit
    assert int(bv[:, -1].max()) >= min(L, 2)
