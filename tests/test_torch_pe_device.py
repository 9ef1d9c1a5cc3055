"""The port's device paired-end pieces (ops/pe_device, plain PyTorch on
the CPU) against fastquick_tpu's: hash_64 on u32 pairs, the histogram
insert-size inference, occurrence expansion and the pairing sweep on the
worlds of tests/test_pe_device.py (48 pairs with a planted repeat), the
second pairing pass's no-op on an empty pair set, and the one-program
step with mate rescue injected (pe_fill) on the rescue world of
tests/test_pe_rescue_device.py.  Integers identical; the insert-size
estimate's floats within 1e-6 relative."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread per test worker

from fastquick_tpu.align import pe as hpe  # noqa: E402
from fastquick_tpu.align.opts import G_LOG_N, GapOpt, PeOpt  # noqa: E402
from fastquick_tpu.ops import pe_device as dpe  # noqa: E402
from fastquick_tpu_torch.ops import pe_device as tpe  # noqa: E402

import qc_step_oracle as qso  # noqa: E402

from test_pe_device import _R, _pack_rows, _world  # noqa: E402
from test_pe_rescue_device import world as rescue_world  # noqa: E402,F401

G_T = torch.tensor(G_LOG_N, dtype=torch.long)
G_J = jnp.asarray(np.array(G_LOG_N, np.int32))


def _t(x):
    return torch.from_numpy(np.array(x))


def test_hash64_matches_jax_and_host():
    rng = np.random.default_rng(0)
    keys = [int(rng.integers(0, 2 ** 63)) * 2 + int(rng.integers(0, 2))
            for _ in range(300)]
    hi = np.array([k >> 32 for k in keys], np.uint32)
    lo = np.array([k & 0xFFFFFFFF for k in keys], np.uint32)
    th, tl = tpe.hash_64_u32(_t(hi.astype(np.int64)),
                             _t(lo.astype(np.int64)))
    jh, jl = dpe.hash_64_u32(jnp.asarray(hi), jnp.asarray(lo))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    for k, h, ll in zip(keys, th.tolist(), tl.tolist()):
        assert (h << 32) | ll == hpe.hash_64(k)


def _assert_ii(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # the integer fields of the estimate: validity and the window bounds
    np.testing.assert_array_equal(got[[0, 3, 4, 5]], want[[0, 3, 4, 5]])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_isize_inference_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 400
    pos0 = rng.integers(0, 10_000, n)
    isz = np.clip(rng.normal(300, 40, n).astype(int), 120, 3000)
    mq = rng.choice([0, 25, 37], size=(n, 2), p=[0.2, 0.2, 0.6])
    pairs = [(_R(int(pos0[i]), 100, int(mq[i, 0])),
              _R(int(pos0[i] + isz[i] - 100), 100, int(mq[i, 1])))
             for i in range(n)]
    cols = [np.array([getattr(p[j], f) for p in pairs], np.int32)
            for f, j in (("pos", 0), ("pos", 1), ("len", 0), ("len", 1),
                         ("mapQ", 0), ("mapQ", 1))]
    both = np.ones(n, bool)
    jh, jm = dpe.isize_hist_local(*(jnp.asarray(c) for c in cols),
                                  jnp.asarray(both))
    th, tm = tpe.isize_hist_local(*(_t(c) for c in cols), _t(both))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert int(tm) == int(jm)
    want = dpe.infer_isize_from_hist(jh, jm, 1e-5, 2_000_000)
    got = tpe.infer_isize_from_hist(th, tm, 1e-5, 2_000_000)
    _assert_ii(got, want)
    assert float(got[0]) > 0
    # a batch that fails carries the last estimate forward
    last = got.clone()
    few = th.clone()
    few[few > 0] = 0
    few[300] = 5
    carried = tpe.infer_isize_from_hist(few, tm, 1e-5, 2_000_000,
                                        last_ii=last)
    np.testing.assert_array_equal(carried.numpy(), last.numpy())


def _pair_inputs(seed):
    """The aligned pairs of test_pe_device's pairing world: SE state per
    end, packed hit rows, the insert-size vector and pair_ok, as numpy."""
    from fastquick_tpu.align.core import bwa_aln2seq_core, bwa_approx_mapQ
    from fastquick_tpu.align.engine import HostEngine
    from fastquick_tpu.align.opts import bwa_cal_maxdiff
    from fastquick_tpu.align.rand import Rand48
    from fastquick_tpu.align.seqs import Read, seq_reverse

    idx = _world(seed)
    opt, popt = GapOpt(), PeOpt()
    rng = np.random.default_rng(seed)
    reads = []
    for r in range(48):
        if r % 6 == 5:  # pairs inside the planted repeat
            s = int(rng.integers(10_100, 11_300))
        else:
            s = int(rng.integers(0, len(idx.text) - 600))
        isz = int(rng.integers(240, 420))
        for endj in (0, 1):
            codes = (idx.text[s:s + 100].copy() if endj == 0 else
                     (3 - idx.text[s + isz - 100:s + isz])[::-1].copy())
            for _ in range(rng.binomial(100, 0.01)):
                pp = int(rng.integers(0, 100))
                codes[pp] = (codes[pp] + 1) % 4
            p = Read()
            p.len = p.full_len = p.clip_len = 100
            p.seq = seq_reverse(codes, False)
            p.rseq = seq_reverse(codes, True)
            p.qual = np.full(100, 70, np.uint8)
            reads.append(p)
    HostEngine(idx).align_batch(reads, opt)
    rngd = Rand48(11)
    fms = (idx.fm_fwd, idx.fm_rev)
    for p in reads:
        bwa_aln2seq_core(p.aln, p, True, 0, rngd)
        if p.type in (1, 2):
            p.pos = hpe.sa_pos(fms, p.strand, p.sa, p.len)
            p.seQ = p.mapQ = bwa_approx_mapQ(
                p, bwa_cal_maxdiff(p.len, thres=opt.fnr))
    b0, b1 = reads[0::2], reads[1::2]
    ii = hpe.IsizeInfo()
    hpe.infer_isize(list(zip(b0, b1)), ii, popt.ap_prior, idx.l_pac)
    assert ii.avg > 0

    def se_state(batch):
        return {f: np.array([getattr(p, a) for p in batch], np.int32)
                for f, a in (("pos", "pos"), ("strand", "strand"),
                             ("mapq", "mapQ"), ("seq_q", "seQ"),
                             ("n_mm", "n_mm"), ("n_gapo", "n_gapo"),
                             ("n_gape", "n_gape"), ("len", "len"))}

    K = 32
    pair_ok = np.array([p0.type in (1, 2) and p1.type in (1, 2)
                        and sum(a.l - a.k + 1 for a in p0.aln) <= K
                        and sum(a.l - a.k + 1 for a in p1.aln) <= K
                        for p0, p1 in zip(b0, b1)])
    ii_vec = np.array([1.0, ii.avg, ii.std, ii.low, ii.high,
                       ii.high_bayesian, ii.ap_prior], np.float32)
    return dict(idx=idx, se=(se_state(b0), se_state(b1)),
                alns=tuple(np.stack([_pack_rows(p.aln) for p in b])
                           for b in (b0, b1)),
                n_aln=tuple(np.array([len(p.aln) for p in b], np.int32)
                            for b in (b0, b1)),
                pair_ok=pair_ok, ii=ii_vec, K=K, s_mm=opt.s_mm,
                max_isize=popt.max_isize)


@pytest.mark.parametrize("seed", [11, 12])
def test_pairing_sweep_matches_jax(seed):
    from fastquick_tpu.ops.fm import DeviceFM as JDeviceFM

    x = _pair_inputs(seed)
    idx = x["idx"]
    sa = JDeviceFM.build(idx.fm_fwd, idx.fm_rev).sa
    sa_t = _t(np.asarray(sa))
    n = idx.fm_fwd.n
    occ_j, occ_t = [], []
    for j in (0, 1):
        occ_j.append(dpe.expand_occurrences(
            sa, n, jnp.asarray(x["n_aln"][j]), jnp.asarray(x["alns"][j]),
            jnp.asarray(x["se"][j]["len"]), x["K"]))
        occ_t.append(tpe.expand_occurrences(
            sa_t, n, _t(x["n_aln"][j]), _t(x["alns"][j]),
            _t(x["se"][j]["len"]), x["K"]))
        for k in ("pos", "row", "valid", "n_occ"):
            np.testing.assert_array_equal(occ_t[j][k].numpy(),
                                          np.asarray(occ_j[j][k]), err_msg=k)
    want = dpe.pairing_sweep(
        *occ_j, *(jnp.asarray(a) for a in x["alns"]),
        *({k: jnp.asarray(v) for k, v in s.items()} for s in x["se"]),
        jnp.asarray(x["pair_ok"]), jnp.asarray(x["ii"]), x["s_mm"],
        x["max_isize"], G_J)
    got = tpe.pairing_sweep(
        *occ_t, *(_t(a) for a in x["alns"]),
        *({k: _t(v) for k, v in s.items()} for s in x["se"]),
        _t(x["pair_ok"]), _t(x["ii"]), x["s_mm"], x["max_isize"], G_T)
    for j in (0, 1):
        for k, w in want[j].items():
            np.testing.assert_array_equal(got[j][k].numpy(), np.asarray(w),
                                          err_msg=f"end {j} {k}")
    assert int(got[2]) == int(want[2])
    assert bool(got[0]["proper"].any())


def test_sweep_without_pairs_changes_nothing():
    """With pair_ok all false the sweep finds no pair, counts no change and
    returns the SE state: the qc_full second pass over an empty pair set is
    a no-op, which is why it is skipped."""
    x = _pair_inputs(11)
    idx = x["idx"]
    from fastquick_tpu_torch.ops.fm import DeviceFM

    sa = DeviceFM.build(idx.fm_fwd, idx.fm_rev, "cpu").sa
    occ = [tpe.expand_occurrences(sa, idx.fm_fwd.n, _t(x["n_aln"][j]),
                                  _t(x["alns"][j]), _t(x["se"][j]["len"]),
                                  x["K"]) for j in (0, 1)]
    se = [{k: _t(v) for k, v in s.items()} for s in x["se"]]
    out0, out1, cnt = tpe.pairing_sweep(
        *occ, *(_t(a) for a in x["alns"]), *se,
        torch.zeros(len(x["pair_ok"]), dtype=torch.bool), _t(x["ii"]),
        x["s_mm"], x["max_isize"], G_T)
    assert int(cnt) == 0
    for out, s in ((out0, se[0]), (out1, se[1])):
        assert not bool(out["proper"].any())
        for k, v in s.items():
            np.testing.assert_array_equal(out[k].numpy(), v.numpy())


def test_rescue_world_pe_fill_matches_jax(rescue_world):  # noqa: F811
    """The rescue world: the first pass, then the host's rescue and refine
    of candidate pairs (test_pe_rescue_device's recipe) injected as
    pe_fill into both packages' second pass (fastquick_tpu's given each
    read as align --device_qc orients it, tests/qc_step_oracle.py)."""
    from fastquick_tpu.align.core import BWA_TYPE_UNIQUE
    from fastquick_tpu.align.pe import (BWA_TYPE_MATESW, BWA_TYPE_NO_MATCH,
                                        SAM_FPP, bwa_paired_sw,
                                        infer_isize_from_hist_f64)
    from fastquick_tpu.align.refine import refine_gapped_core
    from fastquick_tpu.ops.qc_full import pack_pe_fill
    from fastquick_tpu_torch import qc_program as qp
    from test_drand48_qc import _device_run
    from test_pe_qc_differential import _load, _read_pairs
    from test_torch_qc_full import assert_same
    from test_torch_qc_program import port_world

    with qso.oriented():
        _, acc1 = _device_run(rescue_world)
    w = port_world(rescue_world)
    stats1, rows_t1 = qp.run_single(w)
    assert_same({k: v for k, v in acc1.items()}, stats1, rows_t1)
    rows1 = {k: np.asarray(v) for k, v in acc1["_pair_rows"].items()}
    P = rows1["status"].shape[0]

    idx, opt, _ = _load(rescue_world)
    b0, b1 = _read_pairs(rescue_world, idx, opt)
    for i in range(P):
        for j, p in ((0, b0[i]), (1, b1[i])):
            mapped = bool(rows1[f"mapped{j}"][i])
            p.type = BWA_TYPE_UNIQUE if mapped else BWA_TYPE_NO_MATCH
            for a, f in (("pos", "pos"), ("strand", "strand"),
                         ("mapQ", "mapq"), ("seQ", "seq_q"),
                         ("n_mm", "n_mm"), ("n_gapo", "n_gapo"),
                         ("n_gape", "n_gape")):
                setattr(p, a, int(rows1[f"{f}{j}"][i]))
            if bool(rows1["proper"][i]):
                p.extra_flag |= SAM_FPP
            if not mapped:  # the host's calloc'd state of unmapped ends
                p.pos = p.mapQ = p.seQ = 0
    popt = PeOpt()
    ii = infer_isize_from_hist_f64(np.asarray(acc1["_isize_hist"]),
                                   int(acc1["_isize_maxlen"]),
                                   popt.ap_prior, len(idx.text))
    bwa_paired_sw(idx.text, list(zip(b0, b1)), popt, ii, opt.mode)
    inj = set(i for i in range(P) if b0[i].type == BWA_TYPE_MATESW
              or b1[i].type == BWA_TYPE_MATESW)
    n_resc = len(inj)
    for i in range(P):
        if i in inj:
            continue
        for j, p in ((0, b0[i]), (1, b1[i])):
            if p.type in (BWA_TYPE_NO_MATCH, BWA_TYPE_MATESW) \
                    or p.n_gapo == 0:
                continue
            fwd = p.seq[: p.len][::-1]
            seq = p.rseq[: p.len] if p.strand else fwd
            ext = (1 if p.strand else -1) * (p.n_gapo + p.n_gape)
            p.cigar, p.pos = refine_gapped_core(
                idx.text, p.len, np.asarray(seq, np.uint8), p.pos, ext)
            inj.add(i)
    assert n_resc >= 8 and len(inj) > n_resc
    inj = sorted(inj)
    fill = pack_pe_fill([(b0[i], b1[i]) for i in inj], inj, P)
    with qso.oriented():
        _, acc = _device_run(rescue_world, pe_fill={
            k: jnp.asarray(v) for k, v in fill.items()})
    got, rows = qp.run_single(w, pe_fill={k: _t(v) for k, v in
                                          fill.items()})
    assert_same(acc, got, rows)
    assert int(got["n_pcr_dup"]) == int(acc["n_pcr_dup"])
    assert int(got["n_pair_reads"]) == int(acc["n_pair_reads"]) > 0
