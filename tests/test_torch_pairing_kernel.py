"""The pairing kernels' steps (csrc/pairing_body.cuh and the networks of
csrc/pairing.cu, built for the host with g++ as fq_pairing_host and called
with the arguments ops/pe_device.sweep_call gives the launch: the unsorted
occurrence planes) against the port's plain sweep (pairing_sweep_plain,
two stable argsorts and a loop) and fastquick_tpu's pairing_sweep: the
worlds of tests/test_pe_device.py with the insert-size window's high
bound set and not, a penalty that is inf or nan (INT_MIN added to the
score word), pairs built so that two candidates share a hash (the key's
tie and reset paths), the sweeps of the one-program step on the
occurrence-overflow world of tests/test_pe_occ_overflow.py, whose second
pass runs at k_occ2 = 512 (2 x 512 entries a pair: the block kernel), and
entries on the edges of the sort key.  Every output field and cnt_chg
identical.  Also: the plain version's sorted planes hold every valid
entry before any invalid one."""

import functools
import shutil
from unittest import mock

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread per test worker

from fastquick_tpu.ops import pe_device as dpe  # noqa: E402
from fastquick_tpu_torch import qc_program as qp  # noqa: E402
from fastquick_tpu_torch.ops import pe_device as tpe  # noqa: E402
from fastquick_tpu_torch.ops import qc_full  # noqa: E402

from test_pe_occ_overflow import world as occ_world  # noqa: E402,F401
from test_torch_pe_device import G_J, G_T, _pair_inputs, _t  # noqa: E402
from test_torch_qc_program import port_world  # noqa: E402

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="needs g++")


def _host(*args):
    """pairing_sweep with the kernel's body built for the host, on the
    arguments sweep_call hands the kernel (the unsorted planes)."""
    from fastquick_tpu_torch.kernels.build import host_library

    call = tpe.sweep_call(*args)
    assert host_library().fq_pairing_host(*call.args) == 0
    return tpe.sweep_outputs(args[4], args[5], *call.outputs)


# compiled once a shape (s_mm and max_isize static), as qc_full runs it
_jax_sweep = jax.jit(dpe.pairing_sweep, static_argnums=(8, 9))


def _jax(occ0, occ1, a0, a1, se0, se1, pair_ok, ii, s_mm, max_isize):
    """fastquick_tpu's pairing_sweep on the same inputs."""
    def j(t):
        return jnp.asarray(t.numpy())

    def occ(o):
        return {k: j(v) for k, v in o.items()}

    def se(s):
        return {k: j(v.to(torch.int32)) for k, v in s.items()}

    return _jax_sweep(occ(occ0), occ(occ1), j(a0), j(a1), se(se0),
                      se(se1), j(pair_ok), j(ii), s_mm, max_isize, G_J)


def _assert_same(got, want, what):
    for j in (0, 1):
        for k, w in want[j].items():
            np.testing.assert_array_equal(
                np.asarray(got[j][k]).astype(np.int64),
                np.asarray(w).astype(np.int64),
                err_msg=f"{what}: end {j} {k}")
    assert int(got[2]) == int(want[2]), what


def _check(args, what, jax_too=True):
    """Host build == plain (== JAX) on one sweep's inputs; the plain
    result."""
    want = tpe.pairing_sweep_plain(*args)
    got = _host(*args)
    for j in (0, 1):
        for k, w in want[j].items():
            assert got[j][k].dtype == w.dtype, (what, k)
            assert torch.equal(got[j][k], w), f"{what}: host end {j} {k}"
    assert int(got[2]) == int(want[2]), what
    if jax_too:
        _assert_same(want, _jax(*args[:-1]), f"{what}: plain vs JAX")
    return want


@functools.lru_cache(maxsize=None)
def _world(seed):
    """test_pe_device's aligned world of one seed (aligned once)."""
    return _pair_inputs(seed)


def _world_args(seed, has_high=True):
    from fastquick_tpu_torch.ops.fm import DeviceFM

    x = _world(seed)
    idx = x["idx"]
    sa = DeviceFM.build(idx.fm_fwd, idx.fm_rev, "cpu").sa
    occ = [tpe.expand_occurrences(sa, idx.fm_fwd.n, _t(x["n_aln"][j]),
                                  _t(x["alns"][j]), _t(x["se"][j]["len"]),
                                  x["K"]) for j in (0, 1)]
    se = [{k: _t(v) for k, v in s.items()} for s in x["se"]]
    ii = _t(x["ii"]).clone()
    if not has_high:
        ii[4] = 0.0
    return [*occ, *(_t(a) for a in x["alns"]), *se, _t(x["pair_ok"]), ii,
            x["s_mm"], x["max_isize"], G_T]


@pytest.mark.parametrize("has_high", [True, False])
@pytest.mark.parametrize("seed", [11, 12])
def test_world_matches_plain_and_jax(seed, has_high):
    out0, _, _ = _check(_world_args(seed, has_high),
                        f"seed {seed}, has_high {has_high}")
    assert bool(out0["proper"].any())


def test_inf_and_nan_penalty():
    """std 0 and avg on one pair's insert: that pair's ratio is 0/0 (nan),
    every other insert's x/0 (inf); both penalties are INT_MIN, which the
    score word takes with C's int wrap."""
    args = _world_args(11)
    se0, se1 = args[4], args[5]
    proper = (se0["strand"] != se1["strand"]).nonzero()[:, 0]
    i = int(proper[0])
    lo = min(int(se0["pos"][i]), int(se1["pos"][i]))
    hi = max(int(se0["pos"][i]), int(se1["pos"][i]))
    insert = hi + int(se0["len"][i]) - lo
    ii = args[7]
    ii[1], ii[2] = float(insert), 0.0
    l_vals = torch.tensor([insert, insert + 7])
    ratio = tpe._div(torch.abs(tpe._f32(l_vals) - ii[1]), ii[2])
    assert bool(torch.isnan(ratio[0])) and bool(torch.isinf(ratio[1]))
    assert (tpe._penalty(l_vals, ii[1], ii[2]) == tpe.INT_MIN).all()
    out0, _, _ = _check(args, "inf/nan penalty")
    assert bool(out0["proper"].any())


def _tie_pairs(n: int, rng):
    """n pairs whose end 0 has two forward rows of one occurrence each at
    the same position X (row 1's score 0, 1 or 2 classes above row 0's)
    and whose end 1 has one reverse occurrence 200-400 bp on: its two
    candidates share the hash, and their score words tie or differ by a
    few units.  K = 4 occurrence slots."""
    K = 4
    X = rng.integers(1000, 1 << 24, n)
    Y = X + rng.integers(100, 300, n)
    sc = rng.integers(0, 3, n)
    bump = np.arange(n) % 3

    def word(mm, strand, score):
        return (mm | strand << 18 | score << 19).astype(np.int32)

    a0 = np.zeros((n, 48, 3), np.int32)
    a1 = np.zeros((n, 48, 3), np.int32)
    k = rng.integers(0, 1 << 20, n)
    a0[:, 0] = np.stack([word(sc, 0, sc), k, k], 1)
    a0[:, 1] = np.stack([word(sc + bump, 0, sc + bump), k + 1, k + 1], 1)
    a1[:, 0] = np.stack([word(sc, 1, sc), k + 2, k + 2], 1)
    slots = np.broadcast_to(np.arange(K), (n, K))
    occ0 = dict(pos=np.where(slots < 2, X[:, None], 0).astype(np.int32),
                row=np.where(slots == 1, 1, 0).astype(np.int32),
                valid=slots < 2, n_occ=np.full(n, 2, np.int32))
    occ1 = dict(pos=np.where(slots < 1, Y[:, None], 0).astype(np.int32),
                row=np.zeros((n, K), np.int32), valid=slots < 1,
                n_occ=np.ones(n, np.int32))
    mq = rng.choice([0, 0, 23, 37], (2, n)).astype(np.int32)

    def se(j, pos, meta):
        return dict(pos=pos.astype(np.int32), strand=np.full(n, j, np.int32),
                    mapq=mq[j], seq_q=mq[j], n_mm=meta & 63,
                    n_gapo=(meta >> 6) & 63, n_gape=(meta >> 12) & 63,
                    len=np.full(n, 100, np.int32))

    ii = np.array([1.0, 300.0, 40.0, 150.0, 500.0, 700.0, 1e-5], np.float32)
    return (occ0, occ1, a0, a1, se(0, X, a0[:, 0, 0]), se(1, Y, a1[:, 0, 0]),
            np.ones(n, bool), ii)


def test_tied_and_close_candidates():
    """Two candidates with one hash: tied score words take the key's
    same-word count (o_n 2: pair mapQ 0), words a few units apart the
    reset of subo_n and the g_log_n mapQ; ends of mapQ 0 take the pair
    mapQ."""
    occ0, occ1, a0, a1, se0, se1, ok, ii = _tie_pairs(
        300, np.random.default_rng(21))
    args = [{k: _t(v) for k, v in occ0.items()},
            {k: _t(v) for k, v in occ1.items()}, _t(a0), _t(a1),
            {k: _t(v) for k, v in se0.items()},
            {k: _t(v) for k, v in se1.items()}, _t(ok), _t(ii), 3, 500, G_T]
    out0, out1, _ = _check(args, "tied candidates")
    assert bool(out0["proper"].all())
    # mapQ 0 ends: min(pair mapQ + 7, mate's), so ties leave 7 and close
    # words more
    fixed = out0["mapq"][(_t(se0["mapq"]) == 0) & (_t(se1["mapq"]) > 0)]
    assert {7} < set(fixed.tolist())


def test_occ_overflow_world_sweeps(occ_world):  # noqa: F811
    """Both pairing passes of the one-program step on the overflow world
    (k_occ 32, then k_occ2 512 for the pairs the first cap truncated),
    their inputs recorded from the run; the JAX sweep is held to the
    second pass (test_torch_qc_program holds the whole step to JAX's)."""
    calls = []
    sweep = qc_full.pairing_sweep

    def record(*args):
        calls.append(args)
        return sweep(*args)

    w = port_world(occ_world, k_occ2=512)
    with mock.patch.object(qc_full, "pairing_sweep", record):
        qp.run_single(w)
    assert [c[0]["pos"].shape[1] for c in calls] == [32, 512]
    for args in calls:
        K = args[0]["pos"].shape[1]
        out0, _, _ = _check(list(args), f"occ world, K {K}", K == 512)
        assert bool(out0["proper"].any())


def _word(rng, shape):
    """Random packed hit-row words: mm, gap opens and extensions, strand,
    score."""
    strand = rng.integers(0, 2, shape)
    score = rng.integers(0, 6, shape)
    return (rng.integers(0, 4, shape) | rng.integers(0, 2, shape) << 6
            | rng.integers(0, 3, shape) << 12 | strand << 18
            | score << 19).astype(np.int32)


def _crafted(rng, pos, row, n_occ, ok=None):
    """pairing_sweep's arguments from each end's (P, K) positions and rows
    and (P,) occurrence counts (valid: t < n_occ); each end's six hit rows
    get random words, its SE state its first entry's position and row
    strand (a random locus when it has none), mapQ 0, 23, 37 or 60."""
    P, K = pos[0].shape
    t = np.arange(K)[None, :]
    occ, alns, se = [], [], []
    for j in (0, 1):
        valid = t < n_occ[j][:, None]
        occ.append({"pos": _t(np.where(valid, pos[j], 0).astype(np.int32)),
                    "row": _t(np.where(valid, row[j], 0).astype(np.int32)),
                    "valid": _t(valid),
                    "n_occ": _t(n_occ[j].astype(np.int32))})
        a = np.zeros((P, 48, 3), np.int32)
        a[:, :6, 0] = _word(rng, (P, 6))
        alns.append(_t(a))
        meta = a[np.arange(P), row[j][:, 0], 0]
        mapq = rng.choice([0, 23, 37, 60], P).astype(np.int32)
        se.append({k: _t(np.asarray(v, np.int32)) for k, v in dict(
            pos=np.where(n_occ[j] > 0, pos[j][:, 0],
                         rng.integers(0, 1 << 20, P)),
            strand=(meta >> 18) & 1, mapq=mapq, seq_q=mapq,
            n_mm=meta & 63, n_gapo=(meta >> 6) & 63,
            n_gape=(meta >> 12) & 63,
            len=rng.choice([100, 150], P)).items()})
    ok = np.ones(P, bool) if ok is None else ok
    ii = _t(np.array([1.0, 300.0, 40.0, 150.0, 500.0, 700.0, 1e-5],
                     np.float32))
    return [*occ, *alns, *se, _t(ok), ii, 3, 500, G_T]


def _case(name, rng):
    """Pairs whose entries take the order's edges (see
    test_crafted_entries)."""
    P, K = {"all_slots": (64, 32), "full_k512": (3, 512)}.get(name, (200, 8))
    locus = rng.integers(1000, 1 << 24, P)[:, None]

    def near(width):
        return locus + rng.integers(-width, width, (P, K))

    rows = [np.sort(rng.integers(0, 6, (P, K)), 1) for _ in (0, 1)]
    n_occ = [rng.integers(1, K + 1, P) for _ in (0, 1)]
    ok = None
    if name == "equal_positions":  # three positions for every entry
        pos = [locus + rng.choice([0, 150, 260], (P, K)) for _ in (0, 1)]
    elif name == "max_position":  # up to and at 2^31 - 1
        pos = [np.minimum(2 ** 31 - 1 - rng.integers(0, 900, (P, K))
                          * (rng.random((P, K)) < 0.7), 2 ** 31 - 1)
               for _ in (0, 1)]
    elif name == "negative_positions":
        pos = [rng.integers(-1500, 1500, (P, K)) for _ in (0, 1)]
    elif name == "empty_and_not_ok":
        pos = [near(500), near(500)]
        for j in (0, 1):
            n_occ[j][rng.random(P) < 0.35] = 0
        ok = rng.random(P) < 0.75
    elif name in ("all_slots", "full_k512"):  # every slot valid
        pos = [near(600), near(600)]
        n_occ = [np.full(P, K), np.full(P, K)]
    else:  # reverse_key_order: every key below the one before it
        hi = locus + 500 + np.sort(rng.integers(0, 300, (P, K)), 1)[:, ::-1]
        lo = locus + np.sort(rng.integers(0, 300, (P, K)), 1)[:, ::-1]
        pos = [hi, lo]
        rows = [r[:, ::-1] for r in rows]  # ties: the higher row first
    return _crafted(rng, pos, rows, n_occ, ok)


@pytest.mark.parametrize("name", [
    "equal_positions", "max_position", "negative_positions",
    "empty_and_not_ok", "all_slots", "full_k512", "reverse_key_order"])
def test_crafted_entries(name):
    """The in-kernel order against the plain version's two stable sorts and
    JAX's, on the edges of the key: equal positions in different rows and
    in both ends; valid positions at 2^31 - 1 (the invalid entries' sort
    key in the plain version); negative positions; pairs with no valid
    entry on one or both ends and pairs that do not enter pairing; every
    one of the 64 slots valid at K 32 (both keys of every lane) and every
    one of 1,024 at K 512 (the block network); entries handed in reverse
    key order."""
    args = _case(name, np.random.default_rng(sum(map(ord, name))))
    out0, out1, _ = _check(args, name)
    assert bool(out0["proper"].any())
    if name == "empty_and_not_ok":
        off = ~args[6] | (args[0]["n_occ"] == 0) | (args[1]["n_occ"] == 0)
        assert not bool(out0["proper"][off].any())
    if name == "max_position":
        assert bool((args[0]["pos"] == 2 ** 31 - 1).any())


@pytest.mark.parametrize("seed", [0, 1])
def test_valid_entries_come_first(seed):
    """The plain version's two stable sorts hold every valid entry before
    any invalid one (the order the kernel's key gives, which sorts the
    valid entries only): with scattered valid flags, positions at both ends
    of int32 (a valid 2^31 - 1 ties with the invalid entries' sort key) and
    pairs that do not enter pairing."""
    rng = np.random.default_rng(seed)
    P, K = 64, 16

    def occ():
        pos = rng.integers(0, 2 ** 31, (P, K)).astype(np.int32)
        pos[rng.random((P, K)) < 0.2] = 2 ** 31 - 1
        pos[rng.random((P, K)) < 0.1] = 0
        return {"pos": torch.from_numpy(pos),
                "row": torch.from_numpy(
                    rng.integers(0, 48, (P, K)).astype(np.int32)),
                "valid": torch.from_numpy(rng.random((P, K)) < 0.5)}

    o0, o1 = occ(), occ()
    pair_ok = torch.from_numpy(rng.random(P) < 0.9)
    _, _, _, valid = tpe._merged_entries(o0, o1, pair_ok)
    n = valid.sum(1, keepdim=True)
    assert torch.equal(valid, torch.arange(2 * K)[None, :] < n)
    want = ((o0["valid"].sum(1) + o1["valid"].sum(1)) * pair_ok)[:, None]
    assert torch.equal(n, want)
