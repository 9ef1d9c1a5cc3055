"""The port's drand48 reservoir draw (plain version, and the kernel's tiles
built for the host with g++) against fastquick_tpu's aln2seq_draw_scan
and its HostDraw oracle: random hit-list batches, batches of several
tiles (mixed, every read a single row, and best classes of up to 48
rows that end tiles early), states whose next draw is 0
on a single-row read (the kernel's speculation breaks and resumes) and on
a multi-row read, the empty batch, and single reads engineered onto the
double rounding boundaries of the acceptance test and of the SA-row
offset.  Selected field words, rows and the stream state must be
identical."""

import ctypes
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread per test worker

from fastquick_tpu.ops import drand48_device as jd  # noqa: E402
from fastquick_tpu_torch.ops import drand48_device as td  # noqa: E402
from fastquick_tpu_torch.testing.drand48_cases import (  # noqa: E402
    boundary_cases,
    random_batch,
    single_batch,
    zero_draw_state,
)

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="needs g++")


def _jax(n_aln, alns, state):
    f0, row, st = jd.aln2seq_draw_scan(jnp.asarray(n_aln), jnp.asarray(alns),
                                       jnp.asarray(state), A_MAX=48)
    return np.asarray(f0), np.asarray(row), np.asarray(st)


def _plain(n_aln, alns, state):
    out = td.aln2seq_draw_scan(torch.from_numpy(n_aln),
                               torch.from_numpy(alns),
                               torch.from_numpy(np.array(state)))
    return tuple(t.numpy() for t in out)


def _host(n_aln, alns, state):
    """The drand48 kernel's walk built with g++ (fq_drand48_host)."""
    from fastquick_tpu_torch.kernels.build import host_library

    n_aln = np.ascontiguousarray(n_aln, np.int32)
    alns = np.ascontiguousarray(alns, np.int32)
    state = np.ascontiguousarray(state, np.int32)
    N = n_aln.shape[0]
    f0 = np.zeros(N, np.int32)
    row = np.zeros(N, np.int32)
    st = np.zeros(4, np.int32)

    def p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    assert host_library().fq_drand48_host(p(n_aln), p(alns), N, p(state),
                                          p(f0), p(row), p(st)) == 0
    return f0, row, st


def _assert_same(got, want, what):
    for name, g, w in zip(("f0", "row", "state"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_batches_match_jax(seed):
    """Three fuzz batches, the second continuing the first's stream."""
    rng = np.random.default_rng(seed)
    n_aln, alns, _ = random_batch(rng, 400)
    state = jd.seed_state(11)
    np.testing.assert_array_equal(td.seed_state(11), state)
    want = _jax(n_aln, alns, state)
    _assert_same(_plain(n_aln, alns, state), want, "plain")
    if shutil.which("g++"):
        _assert_same(_host(n_aln, alns, state), want, "host build")
    n2, a2, _ = random_batch(rng, 64)
    want2 = _jax(n2, a2, want[2])
    _assert_same(_plain(n2, a2, want[2]), want2, "plain, continued")
    assert (want[0] != 0).sum() > 200


def test_plain_counts_its_draws():
    """stats["draws"] is the walk's LCG steps: that many steps of the
    stream from the seed give the walk's final state."""
    rng = np.random.default_rng(3)
    n_aln, alns, _ = random_batch(rng, 200)
    walk = {}
    out = td.draw_scan_plain(torch.from_numpy(n_aln), torch.from_numpy(alns),
                             torch.from_numpy(td.seed_state(11)), stats=walk)
    h = td.HostDraw(11)
    for _ in range(walk["draws"]):
        h.step()
    assert [(h.x >> (12 * i)) & 0xFFF for i in range(4)] == out[2].tolist()
    assert walk["draws"] > int((n_aln > 0).sum())


@needs_gxx
def test_boundaries_match_jax_and_host_draw():
    """Draws within a few units of a rounding boundary: the port must take
    C's double rounding (HostDraw), not the exact rational answer, and the
    cases must include reads where the two differ."""
    rng = np.random.default_rng(5)
    crossed = {"accept": 0, "offset": 0}
    for state, n_aln, alns, kind, exact in boundary_cases(rng, 120):
        want = _jax(n_aln, alns, state)
        _assert_same(_plain(n_aln, alns, state), want, kind)
        _assert_same(_host(n_aln, alns, state), want, kind)
        h = jd.HostDraw()
        h.x = sum(int(v) << (12 * i) for i, v in enumerate(state))
        w0 = int(alns[0, 0, 2] - alns[0, 0, 1] + 1)
        assert h.accept(w0, 0)
        off = h.sa_off(w0)
        if kind == "accept":
            W = w0 + int(alns[0, 1, 2] - alns[0, 1, 1] + 1)
            acc = h.accept(W, w0)
            assert (int(want[1][0]) >= int(alns[0, 1, 1])) == acc
            crossed[kind] += acc != exact
        else:
            assert int(want[1][0]) == int(alns[0, 0, 1]) + off
            crossed[kind] += off != exact
    assert crossed["accept"] > 0 and crossed["offset"] > 0, crossed


def _all_three(n_aln, alns, state, what):
    """JAX, plain and host build on one batch; JAX's result."""
    want = _jax(n_aln, alns, state)
    _assert_same(_plain(n_aln, alns, state), want, f"{what}: plain")
    _assert_same(_host(n_aln, alns, state), want, f"{what}: host build")
    return want


@needs_gxx
@pytest.mark.parametrize("seed", [7, 8])
def test_batches_of_several_tiles(seed):
    """2,600 reads: three tiles of the kernel, each with serial reads
    between runs of single-row reads."""
    rng = np.random.default_rng(seed)
    n_aln, alns, _ = random_batch(rng, 2600)
    _all_three(n_aln, alns, jd.seed_state(seed), "mixed tiles")


@needs_gxx
def test_single_row_batch():
    """Every read one row of width >= 1: the walk visits no read, each
    tile is one jump and every read draws in the parallel pass."""
    rng = np.random.default_rng(9)
    n_aln, alns = single_batch(rng, 2600)
    want = _all_three(n_aln, alns, jd.seed_state(11), "single rows")
    assert (want[0] != 0).all()


@needs_gxx
def test_long_best_classes():
    """Best classes of 17 to 48 rows, enough rows that tiles end early at
    the kernel's row budget (FQ_DRAND_ROWS)."""
    rng = np.random.default_rng(13)
    n_aln, alns = single_batch(rng, 400)
    nb = rng.integers(17, 49, 400)
    w = alns[:, 0, 2] - alns[:, 0, 1] + 1
    for r in range(400):
        if r % 3 == 0:
            continue  # a single-row read between the long ones
        for i in range(1, nb[r]):
            alns[r, i] = alns[r, 0]
            alns[r, i, 1:] += i * w[r]
        n_aln[r] = nb[r]
    assert int(n_aln.sum()) > 2 * 4096
    _all_three(n_aln, alns, jd.seed_state(11), "long best classes")


@needs_gxx
@pytest.mark.parametrize("at", [0, 37, 1023, 1024, 2000])
def test_zero_draw_on_single_row_read(at):
    """The draw of read `at` (a single row) is 0: it takes one draw and
    selects nothing, and every read after it draws from state 0 on.  At
    the first read, inside a tile, at a tile's last and first read, and
    in the second tile."""
    rng = np.random.default_rng(10 + at)
    n_aln, alns = single_batch(rng, 2600)
    state = zero_draw_state(2 * at)
    want = _all_three(n_aln, alns, state, f"zero draw at {at}")
    assert want[0][at] == 0 and want[1][at] == 0
    assert (np.delete(want[0], at) != 0).all()


@needs_gxx
def test_zero_draw_on_multi_row_read():
    """Read 300's best class has three rows and its first draw is 0: it
    declines that row and goes on drawing from state 0, in the walk."""
    rng = np.random.default_rng(12)
    n_aln, alns = single_batch(rng, 1200)
    at = 300
    n_aln[at] = 3
    for i in (1, 2):
        alns[at, i] = alns[at, 0]
        alns[at, i, 1:] += 1000 * i
    _all_three(n_aln, alns, zero_draw_state(2 * at), "zero draw, 3 rows")


def test_empty_batch():
    n_aln = np.zeros(0, np.int32)
    alns = np.zeros((0, 48, 3), np.int32)
    state = jd.seed_state(11)
    got = _plain(n_aln, alns, state)
    np.testing.assert_array_equal(got[2], state)
    if shutil.which("g++"):
        _assert_same(_host(n_aln, alns, state), got, "empty: host build")
