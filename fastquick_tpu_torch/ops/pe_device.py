"""Device paired-end semantics: isize inference + pairing + pair status.

Counterpart of fastquick_tpu/ops/pe_device.py in plain PyTorch, with the
reference package's results bit for bit:

- infer_isize (libbwa/bwape.c:49-118) over an exact integer histogram of
  candidate insert sizes: quantiles, the censor window and the subset
  moments come from the histogram, in float32 as in the reference package
  (including the C quirk of the variance accumulator starting at -1.0,
  bwape.c:85-88);
- pairing (bwape.c:119-215) over each pair's position-sorted occurrence
  list: on the card one launch of a CUDA kernel (csrc/pairing.cu: each
  pair's entries ordered by a bitonic network, then swept by one thread,
  the u64 pair-score key a uint64_t), on the CPU the plain version, two
  stable argsorts and a lockstep loop over the entries with the key
  (score<<32 | hash_64) carried as two 32-bit words -- both with the
  reference's OR-collision of the hash's high word into the score word
  and the `s>>32 < (o_score<<32 & U64MAX)` comparison, which reduces to
  `o_lo != 0`;
- ProcessPairStatus (src/StatCollector.cpp:623-948) as accumulators.

Integer types: a "u32" below is an int64 tensor holding a value in [0,
2^32), masked after every add, shift and not (torch has no uint32
arithmetic, and `>>` on int64 is arithmetic); other integers are int64
inside and come out in the reference's dtypes (int32 values, bool flags).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import build

ISIZE_HIST = 100_000  # candidate inserts < 100000 (bwape.c:75)
M32 = 0xFFFFFFFF
_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))
_i32 = torch.int32
_i64 = torch.long


# ---------------- u64 as two u32 words ----------------

def _u64_add(ahi, alo, bhi, blo):
    lo = (alo + blo) & M32
    carry = (lo < alo).long()
    return (ahi + bhi + carry) & M32, lo


def _u64_not(hi, lo):
    return hi ^ M32, lo ^ M32


def _u64_shl(hi, lo, k: int):
    if k == 0:
        return hi, lo
    if k >= 32:
        return (lo << (k - 32)) & M32, torch.zeros_like(lo)
    return ((hi << k) | (lo >> (32 - k))) & M32, (lo << k) & M32


def _u64_shr(hi, lo, k: int):
    if k == 0:
        return hi, lo
    if k >= 32:
        return torch.zeros_like(hi), hi >> (k - 32)
    return hi >> k, ((lo >> k) | (hi << (32 - k))) & M32


def _u64_xor(ahi, alo, bhi, blo):
    return ahi ^ bhi, alo ^ blo


def _u64_lt(ahi, alo, bhi, blo):
    return (ahi < bhi) | ((ahi == bhi) & (alo < blo))


def hash_64_u32(hi, lo):
    """hash_64 (align/pe.py:56-70 / bwtaln's khash mix) on u32 pairs."""
    hi, lo = hi.long() & M32, lo.long() & M32
    # key += ~(key << 32)
    nhi, nlo = _u64_not(lo, torch.zeros_like(lo))
    hi, lo = _u64_add(hi, lo, nhi, nlo)
    # key ^= key >> 22
    hi, lo = _u64_xor(hi, lo, *_u64_shr(hi, lo, 22))
    # key += ~(key << 13)
    nhi, nlo = _u64_not(*_u64_shl(hi, lo, 13))
    hi, lo = _u64_add(hi, lo, nhi, nlo)
    # key ^= key >> 8
    hi, lo = _u64_xor(hi, lo, *_u64_shr(hi, lo, 8))
    # key += key << 3
    hi, lo = _u64_add(hi, lo, *_u64_shl(hi, lo, 3))
    # key ^= key >> 15
    hi, lo = _u64_xor(hi, lo, *_u64_shr(hi, lo, 15))
    # key += ~(key << 27)
    nhi, nlo = _u64_not(*_u64_shl(hi, lo, 27))
    hi, lo = _u64_add(hi, lo, nhi, nlo)
    # key ^= key >> 31
    hi, lo = _u64_xor(hi, lo, *_u64_shr(hi, lo, 31))
    return hi, lo


# ---------------- float32 helpers ----------------

def _f32(x) -> torch.Tensor:
    return x.to(torch.float32)


def _div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b, IEEE division of two float32 tensors (a scalar divisor may
    otherwise become a multiply by its reciprocal)."""
    a, b = torch.broadcast_tensors(a, b)
    return a / b.contiguous()


def _erfc_half(x: torch.Tensor) -> torch.Tensor:
    """0.5 * erfc(x / sqrt(2)) in float32."""
    return 0.5 * torch.special.erfc(_div(x, torch.full_like(x, _SQRT2_F32)))


# ---------------- insert-size inference ----------------

def isize_hist_local(pos0, pos1, len0, len1, mapq0, mapq1, both_mapped):
    """This batch's candidate-isize histogram (int32 (ISIZE_HIST,)) + max
    read length (bwape.c:55-66: pairs with both SE mapQ >= 20, x <
    100000)."""
    pos0, pos1 = pos0.long(), pos1.long()
    take = both_mapped & (mapq0 >= 20) & (mapq1 >= 20)
    x = torch.where(pos0 < pos1, pos1 + len1.long() - pos0,
                    pos0 + len0.long() - pos1)
    take = take & (x < ISIZE_HIST) & (x >= 0)
    hist = torch.zeros(ISIZE_HIST, dtype=_i64, device=pos0.device)
    hist.index_add_(0, torch.where(take, x, 0), take.long())
    max_len = torch.maximum(len0.max(), len1.max()).to(_i32)
    return hist.to(_i32), max_len


def infer_isize_from_hist(hist, max_len, ap_prior: float, l_pac: int,
                          last_ii=None):
    """infer_isize (bwape.c:49-118) from the exact integer histogram.
    Returns ii = (ok, avg, std, low, high, high_bayesian, ap_prior) as a
    (7,) float32 vector (ok > 0 means the estimate is valid).  If this batch
    fails (tot < 20 / degenerate std) and last_ii is given, last_ii is
    returned (the driver's carry-forward)."""
    dev = hist.device
    f32 = torch.float32
    v = torch.arange(ISIZE_HIST, dtype=_i64, device=dev)
    h = hist.long()
    tot = h.sum()
    cum = torch.cumsum(h, 0)  # inclusive counts <= v

    def q_at(idx):
        # sorted[idx] (0-based) = smallest v with cum(v) >= idx + 1
        return (cum >= idx + 1).to(torch.int8).argmax()

    # C: isizes[(int)(tot*0.25+0.5)] (float math on an int count is exact
    # in f32 for tot < 2^23)
    p25 = q_at((_f32(tot) * 0.25 + 0.5).long())
    p75 = q_at((_f32(tot) * 0.75 + 0.5).long())
    iqr = _f32(p75 - p25)
    tmp = (_f32(p25) - 2.0 * iqr + 0.499).long()
    low = torch.maximum(tmp, max_len.long())
    high = (_f32(p75) + 2.0 * iqr + 0.499).long()
    in_win = (v >= low) & (v <= high)
    hw = torch.where(in_win, h, 0)
    n = hw.sum()
    s1_hi = (hw * (v >> 8)).sum()
    s1_lo = (hw * (v & 255)).sum()
    avg = _div(256.0 * _f32(s1_hi) + _f32(s1_lo), _f32(n))
    dv = _f32(v) - avg
    # C quirk: the variance accumulator starts at -1.0 (bwape.c:85-88)
    var = -1.0 + (_f32(hw) * dv * dv).sum()
    std = torch.sqrt(_div(var, _f32(n)))

    # y-grid bayesian high bound: first y in 1.00,1.01,... <10 with
    # 0.5*erfc(y/sqrt(2)) < ap_prior/l_pac*(y*std+avg)
    y = 1.0 + 0.01 * torch.arange(900, dtype=f32, device=dev)
    lhs = _erfc_half(y)
    rhs = float(np.float32(ap_prior / l_pac)) * (y * std + avg)
    hit = lhs < rhs
    yk = torch.where(hit.any(), y[hit.to(torch.int8).argmax()],
                     torch.tensor(10.0, dtype=f32, device=dev))
    high_b = (yk * std + avg + 0.499).long()
    n_ap = tot - cum[high_b.clamp(0, ISIZE_HIST - 1)]
    ap2 = _div(0.01 * (_f32(n_ap) + 0.01), _f32(tot))
    ap2 = torch.maximum(ap2, torch.tensor(ap_prior, dtype=f32, device=dev))

    ok = (tot >= 20) & ~torch.isnan(std)

    def sel(a, b):
        return torch.where(ok, _f32(a), torch.tensor(b, dtype=f32,
                                                     device=dev))

    ii = torch.stack([sel(torch.ones((), device=dev), 0.0), sel(avg, -1.0),
                      sel(std, -1.0), sel(low, 0.0), sel(high, 0.0),
                      sel(high_b, 0.0), sel(ap2, float(np.float32(ap_prior)))])
    if last_ii is not None:
        ii = torch.where(ok | (last_ii[0] <= 0.0), ii, last_ii)
    return ii


# ---------------- occurrence expansion ----------------

def expand_occurrences(sa, n_text: int, n_aln, alns, lens, k_occ: int):
    """All hit occurrences of each read as flat arrays (bwa_cal_pac_pos_pe
    builds the same list per pair, src/BwtMapper.cpp:797-840).

    alns: packed kernel rows (B, A_MAX, 3).  Returns dict with (B, k_occ)
    planes pos/row/valid plus per-read n_occ (the TRUE total, so callers
    can detect reads the static cap truncated).  Slot t of a read belongs
    to the row whose occurrences [start, start + w) hold it: the count of
    the rows that end at or before t."""
    B, A, _ = alns.shape
    dev = alns.device
    meta = alns[:, :, 0].long()
    k = alns[:, :, 1].long()
    used = torch.arange(A, device=dev)[None, :] < n_aln.long()[:, None]
    w = torch.where(used, alns[:, :, 2].long() - k + 1, 0)  # (B, A)
    ends = torch.cumsum(w, 1)
    n_occ = ends[:, -1]
    t = torch.arange(k_occ, dtype=_i64, device=dev)[None, :].expand(B, -1)
    valid = t < n_occ[:, None]
    row_of = torch.where(
        valid, torch.searchsorted(ends, t.contiguous(), right=True), 0)
    off = t - (ends - w).gather(1, row_of)
    sa_row = k.gather(1, row_of) + off
    strand = (meta.gather(1, row_of) >> 18) & 1
    sa_row_c = sa_row.clamp(0, n_text)
    pos_f = sa[0][sa_row_c].long()
    pos_r = n_text - (sa[1][sa_row_c].long() + lens.long()[:, None])
    pos = torch.where(strand == 1, pos_f, pos_r)
    return dict(pos=torch.where(valid, pos, 0).to(_i32),
                row=row_of.to(_i32), valid=valid, n_occ=n_occ.to(_i32))


# ---------------- pairing sweep ----------------

INT_MIN = -(2 ** 31)
# the per-end fields the sweep reads (all of them) and writes (all but len)
SE_FIELDS = ("pos", "strand", "mapq", "seq_q", "n_mm", "n_gapo", "n_gape",
             "len")


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-row a[p, idx[p]] for (P, W) a and (P,) idx."""
    return a.gather(1, idx[:, None])[:, 0]


def _merged_entries(occ0, occ1, pair_ok):
    """Each pair's merged entry list in C's sort order (pos<<32 | row<<1 |
    end: two stable sorts, the sub-key first).  Returns (P, 2K) int64
    planes pos, row, end and the bool plane valid."""
    P, K = occ0["pos"].shape
    dev = occ0["pos"].device
    pos = torch.cat([occ0["pos"].long(), occ1["pos"].long()], 1)
    row = torch.cat([occ0["row"].long(), occ1["row"].long()], 1)
    end = torch.cat([torch.zeros((P, K), dtype=_i64, device=dev),
                     torch.ones((P, K), dtype=_i64, device=dev)], 1)
    valid = torch.cat([occ0["valid"], occ1["valid"]], 1) & pair_ok[:, None]
    sub = (row << 1) | end
    o1 = torch.argsort(torch.where(valid, sub, 0x7FFFFFFF), dim=1,
                       stable=True)
    pos_s = pos.gather(1, o1)
    valid_s = valid.gather(1, o1)
    o2 = torch.argsort(torch.where(valid_s, pos_s, 0x7FFFFFFF), dim=1,
                       stable=True)
    order = o1.gather(1, o2)
    return (pos.gather(1, order), row.gather(1, order),
            end.gather(1, order), valid.gather(1, order))


def _row_meta(m0, m1, e_arr, r_arr):
    """The packed word of row r_arr of end e_arr, per pair (mj: end j's
    (P, A_MAX) packed words as int64)."""
    return torch.where(e_arr == 0, m0.gather(1, r_arr),
                       m1.gather(1, r_arr))


def _penalty(l, avg, std):
    """The insert-size penalty of insert l in C's float semantics, with
    the INT_MIN cast of inf/nan ratios (align/pe.py:156-167)."""
    ratio = _div(torch.abs(_f32(l) - avg), std)
    p = -4.343 * torch.log(_erfc_half(ratio)) + 0.499
    bad = torch.isnan(p) | torch.isinf(p) | torch.isnan(ratio)
    return torch.where(bad, INT_MIN, p.long())


def pairing_sweep(occ0, occ1, alns0, alns1, se0, se1, pair_ok,
                  ii, s_mm: int, max_isize: int, g_log_n):
    """pairing (bwape.c:119-215) over P pairs.

    occj: expand_occurrences dicts for end j (the valid entries are the
    prefix t < n_occ); alnsj: packed rows (P, A_MAX, 3); sej: dict of SE
    state per end (pos, strand, mapq, seq_q, n_mm, n_gapo, n_gape, len);
    pair_ok: (P,) pairs that enter pairing at all.  Returns per-end updated
    state (with the chosen-pair flag "proper", the SAM_FPP analog) +
    cnt_chg.

    CUDA tensors launch the pairing kernel (csrc/pairing.cu) once: it
    orders each pair's entries, sweeps them and writes the result; only
    the penalty table is built here.  CPU tensors run
    pairing_sweep_plain."""
    if occ0["pos"].device.type == "cpu":
        return pairing_sweep_plain(occ0, occ1, alns0, alns1, se0, se1,
                                   pair_ok, ii, s_mm, max_isize, g_log_n)
    dev = occ0["pos"].device
    call = sweep_call(occ0, occ1, alns0, alns1, se0, se1, pair_ok, ii, s_mm,
                      max_isize, g_log_n)
    build.require_cuda(*call.keep)
    rc = build.cuda_library().fq_pairing_launch(
        *call.args,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    build.check(rc, "pairing")
    build.launch_counts["pairing"] += 1
    return sweep_outputs(se0, se1, *call.outputs)


def pairing_work(occ0, occ1, alns0, alns1, pair_ok, ii) -> dict:
    """What pairing_sweep's kernel must do on these inputs, for its bound
    (utils/bounds.pairing_bound), as device scalars (nothing read back):
    the pairs, the valid entries, the reverse ones, the distinct packed
    words they name, the least compares that sort each pair's entries
    (log2 n! a pair) and the penalty table's length (penalty_table's, from
    ii without reading it)."""
    P, K = occ0["pos"].shape
    dev = occ0["pos"].device
    n = 0
    valid_n = rev_n = words_n = torch.zeros((), dtype=torch.long, device=dev)
    for occ, a in ((occ0, alns0), (occ1, alns1)):
        c = occ["n_occ"].long().clamp(0, K) * pair_ok.long()
        valid = torch.arange(K, device=dev)[None, :] < c[:, None]
        row = torch.where(valid, occ["row"].long(), 0)
        strand = (a[:, :, 0].long().gather(1, row) >> 18) & 1
        used = torch.zeros(a.shape[:2], dtype=torch.long, device=dev)
        used.scatter_add_(1, row, valid.long())
        n = n + c
        valid_n = valid_n + c.sum()
        rev_n = rev_n + (valid & (strand == 1)).sum()
        words_n = words_n + (used > 0).sum()
    compares = torch.ceil(torch.lgamma(n.double() + 1) / math.log(2)).sum()
    pen_len = torch.where(ii[4] > 0.0, ii[5].long().clamp(min=0) + 1, 1)
    return dict(pairs=P, valid=valid_n, reverse=rev_n, words=words_n,
                compares=compares, penalty_len=pen_len)


class SweepCall(NamedTuple):
    """The pairing kernel's C arguments (before the stream), the tensors
    they point at (alive until the call returns) and its outputs: out
    (2, 7, P) int32, proper (2, P) bool, cnt (1,) int32."""
    args: list
    keep: list
    outputs: tuple


def penalty_table(ii):
    """The penalty of every insert the window admits, pen[l] for l in [0,
    high_b], int32, by the plain version's own operations (a (1,) dummy
    without the high bound), and has_high, high_b: one read of ii[4:6]
    from its device (int() truncates high_b as .long() does)."""
    hi, hb = ii[4:6].tolist()
    has_high = hi > 0.0
    high_b = int(hb) if has_high else 0
    dev = ii.device
    pen = (_penalty(torch.arange(max(high_b, 0) + 1, device=dev), ii[1],
                    ii[2]).to(torch.int32) if has_high
           else torch.zeros(1, dtype=torch.int32, device=dev))
    return pen, has_high, high_b


def sweep_call(occ0, occ1, alns0, alns1, se0, se1, pair_ok, ii,
               s_mm: int, max_isize: int, g_log_n) -> SweepCall:
    """pairing_sweep's arguments as the pairing kernel's C interface takes
    them (csrc/pairing_body.cuh): the unsorted occurrence planes, the
    packed words and the SE fields where the caller keeps them (int32 or
    int64, any stride: a copy only of what is neither), the penalty table,
    and the outputs and the sorted keys' scratch, allocated here."""
    i32 = torch.int32
    P, K = occ0["pos"].shape
    dev = occ0["pos"].device

    def c32(t):
        return t.to(i32).contiguous()

    def words(a):  # row r of pair p at a[p * stride(0) + 3 r]
        a = a.to(i32)
        return a if a.stride()[1:] == (3, 1) else a.contiguous()

    occ = [c32(o[f]) for o in (occ0, occ1) for f in ("pos", "row", "n_occ")]
    a0, a1 = words(alns0), words(alns1)
    ok = pair_ok.to(torch.bool).contiguous()
    se = [s[f] if s[f].dtype in (i32, torch.int64) else s[f].to(i32)
          for s in (se0, se1) for f in SE_FIELDS]
    desc = (ctypes.c_longlong * 48)(
        *(t.data_ptr() for t in se), *(t.stride(0) for t in se),
        *(int(t.dtype == torch.int64) for t in se))
    pen, has_high, high_b = penalty_table(ii)
    g = c32(g_log_n)
    out = torch.empty((2, 7, P), dtype=i32, device=dev)
    proper = torch.empty((2, P), dtype=torch.bool, device=dev)
    cnt = torch.zeros(1, dtype=i32, device=dev)
    # the sorted keys of the warp kernel (2 K <= 64), [entry][pair]
    scratch = torch.empty((2 * K, P) if 2 * K <= 64 else (0,),
                          dtype=torch.int64, device=dev)
    p = build.ptr
    args = [P, K, *(p(t) for t in occ), p(a0), a0.stride(0), p(a1),
            a1.stride(0), p(ok), ctypes.cast(desc, ctypes.c_void_p), p(pen),
            p(g), int(has_high), high_b, max_isize, s_mm, p(out), p(proper),
            p(cnt), p(scratch)]
    # (the cast keeps desc alive with the argument)
    keep = [*occ, a0, a1, ok, *se, pen, g, out, proper, cnt, scratch]
    return SweepCall(args, keep, (out, proper, cnt))


def sweep_outputs(se0, se1, out, proper, cnt):
    """pairing_sweep's result from the kernel's outputs: each end's dict
    with its fields replaced, and cnt_chg."""
    res = []
    for s, fields, pr in zip((se0, se1), out.unbind(0), proper.unbind(0)):
        o = dict(s)
        o.update(zip(SE_FIELDS[:7], fields.unbind(0)))
        o["proper"] = pr
        res.append(o)
    return res[0], res[1], cnt[0]


def pairing_sweep_plain(occ0, occ1, alns0, alns1, se0, se1, pair_ok,
                        ii, s_mm: int, max_isize: int, g_log_n):
    """The plain version of pairing_sweep: the sweep vectorized over the
    pairs, a Python loop over the NK = 2K entries, with the u64 pair-score
    key as two u32 words."""
    P, K = occ0["pos"].shape
    NK = 2 * K
    dev = occ0["pos"].device
    L = lambda x: x.long()  # noqa: E731
    max_len = torch.maximum(L(se0["len"]), L(se1["len"]))
    pos, row, end, valid = _merged_entries(occ0, occ1, pair_ok)
    m0_all, m1_all = L(alns0[:, :, 0]), L(alns1[:, :, 0])
    meta = _row_meta(m0_all, m1_all, end, row)
    strand = (meta >> 18) & 1
    score = (meta >> 19) & 127
    len_of_end = torch.where(end == 0, L(se0["len"])[:, None],
                             L(se1["len"])[:, None])

    avg, std = ii[1], ii[2]
    has_high = bool(ii[4] > 0.0)
    high_b = ii[5].long()

    z = torch.zeros(P, dtype=_i64, device=dev)
    ones = torch.full((P,), M32, dtype=_i64, device=dev)
    o_hi, o_lo, s_hi, s_lo = ones, ones, ones, ones
    o_n, subo_n = z, z
    o_set = torch.zeros(P, dtype=torch.bool, device=dev)
    o_u_pos = o_u_end = o_u_row = o_v_pos = o_v_end = o_v_row = z
    lp_pos = torch.zeros((P, 4), dtype=_i64, device=dev)
    lp_row = torch.zeros((P, 4), dtype=_i64, device=dev)
    lp_valid = torch.zeros((P, 4), dtype=torch.bool, device=dev)
    col4 = torch.arange(4, device=dev)[None, :]

    for t in range(NK):
        e_pos, e_row, e_end = pos[:, t], row[:, t], end[:, t]
        e_val = valid[:, t]
        e_score, e_len = score[:, t], len_of_end[:, t]
        is_rev = e_val & (strand[:, t] == 1)
        is_fwd = e_val & (strand[:, t] == 0)
        # pair with the opposite end's last two forward entries (slot 1 =
        # most recent first, then slot 0; bwape.c:158-160)
        opp = 1 - e_end
        for slot in (1, 0):
            c = opp * 2 + slot
            u_pos, u_row = _take(lp_pos, c), _take(lp_row, c)
            u_valid = _take(lp_valid, c)
            l = e_pos + e_len - u_pos
            gate = (is_rev & u_valid & (e_pos > u_pos) & (l >= max_len)
                    & ((l <= high_b) if has_high else (l <= max_isize)))
            u_score = (_row_meta(m0_all, m1_all, opp[:, None],
                                 u_row[:, None])[:, 0] >> 19) & 127
            s = (e_score + u_score) * 10
            if has_high:
                # int32 add wraps like C's (s + INT_MIN stays the low word
                # the u64 key sees)
                s = ((s + _penalty(l, avg, std) + 2 ** 31) & M32) - 2 ** 31
            # key = (s<<32) | hash_64(u_pos<<32 | v_pos): the hash's high
            # word OR-collides into the score word (C quirk)
            h_hi, h_lo = hash_64_u32(u_pos, e_pos)
            k_hi = (s & M32) | h_hi
            k_lo = h_lo
            same_hi = gate & (k_hi == o_hi)
            # C compares s>>32 < (o_score<<32 & U64MAX): "o_score's low
            # word is nonzero"
            reset = gate & ~same_hi & (o_lo != 0)
            subo_n = torch.where(reset, subo_n + o_n,
                                 torch.where(gate & ~same_hi, subo_n + 1,
                                             subo_n))
            o_n = torch.where(same_hi, o_n + 1, torch.where(reset, 1, o_n))
            better = gate & _u64_lt(k_hi, k_lo, o_hi, o_lo)
            better_sub = gate & ~better & _u64_lt(k_hi, k_lo, s_hi, s_lo)
            s_hi = torch.where(better, o_hi, torch.where(better_sub, k_hi,
                                                         s_hi))
            s_lo = torch.where(better, o_lo, torch.where(better_sub, k_lo,
                                                         s_lo))
            o_hi = torch.where(better, k_hi, o_hi)
            o_lo = torch.where(better, k_lo, o_lo)
            o_set = o_set | better
            o_u_pos = torch.where(better, u_pos, o_u_pos)
            o_u_end = torch.where(better, opp, o_u_end)
            o_u_row = torch.where(better, u_row, o_u_row)
            o_v_pos = torch.where(better, e_pos, o_v_pos)
            o_v_end = torch.where(better, e_end, o_v_end)
            o_v_row = torch.where(better, e_row, o_v_row)

        # forward entries shift into this end's last-two slots:
        # slot0 <- slot1; slot1 <- entry
        col = e_end * 2
        m = is_fwd[:, None]
        sel0 = m & (col4 == col[:, None])
        sel1 = m & (col4 == (col + 1)[:, None])
        old1_pos = _take(lp_pos, col + 1)
        old1_row = _take(lp_row, col + 1)
        old1_val = _take(lp_valid, col + 1)
        lp_pos = torch.where(sel0, old1_pos[:, None], lp_pos)
        lp_row = torch.where(sel0, old1_row[:, None], lp_row)
        lp_valid = torch.where(sel0, old1_val[:, None], lp_valid)
        lp_pos = torch.where(sel1, e_pos[:, None], lp_pos)
        lp_row = torch.where(sel1, e_row[:, None], lp_row)
        lp_valid = lp_valid | sel1
    return _pairing_result(se0, se1, alns0, alns1, o_hi, o_lo, s_hi, s_lo,
                           o_n, subo_n, o_set, o_u_pos, o_u_end, o_u_row,
                           o_v_pos, o_v_row, s_mm, g_log_n)


def _pairing_result(se0, se1, alns0, alns1, o_hi, o_lo, s_hi, s_lo, o_n,
                    subo_n, o_set, o_u_pos, o_u_end, o_u_row, o_v_pos,
                    o_v_row, s_mm: int, g_log_n):
    """The end of pairing (bwape.c:169-215): the pair mapQ and each end's
    update from the sweep's best and second-best keys."""
    found = o_set  # o_score != U64MAX iff some candidate was taken
    # mapQ_p (bwape.c:169-181): the difference is a uint64 subtraction in
    # C, compared unsigned; only the <= s_mm*10 case reaches the g_log_n
    # formula, where the value fits int32
    diff_u = (s_hi - o_hi) & M32
    no_sub = (s_hi == M32) & (s_lo == M32)
    n_cap = subo_n.clamp(0, 255)
    small = diff_u // 2
    mapq_p = torch.where(
        o_n == 1,
        torch.where(no_sub, 29,
                    torch.where(diff_u > s_mm * 10, 23,
                                (small - g_log_n.long()[n_cap]).clamp(
                                    min=0))),
        0)

    # chosen rows per end
    u_is0 = o_u_end == 0
    ch_pos0 = torch.where(u_is0, o_u_pos, o_v_pos)
    ch_row0 = torch.where(u_is0, o_u_row, o_v_row)
    ch_pos1 = torch.where(u_is0, o_v_pos, o_u_pos)
    ch_row1 = torch.where(u_is0, o_v_row, o_u_row)

    def end_update(se, alns, ch_pos, ch_row):
        meta = _take(alns[:, :, 0].long(), ch_row)
        r_strand = (meta >> 18) & 1
        matches = (se["pos"].long() == ch_pos) \
            & (se["strand"].long() == r_strand)
        return meta, r_strand, matches

    meta0, rst0, m0 = end_update(se0, alns0, ch_pos0, ch_row0)
    meta1, rst1, m1 = end_update(se1, alns1, ch_pos1, ch_row1)

    mq0, mq1 = se0["mapq"].long(), se1["mapq"].long()
    sq0, sq1 = se0["seq_q"].long(), se1["seq_q"].long()
    both = m0 & m1
    both_pos = both & (mq0 > 0) & (mq1 > 0)
    mq_sum = (mq0 + mq1).clamp(max=60)
    new_mq0 = torch.where(both_pos, mq_sum, mq0)
    new_mq1 = torch.where(both_pos, mq_sum, mq1)
    fix0 = both & ~both_pos & (mq0 == 0)
    fix1 = both & ~both_pos & (mq1 == 0)
    new_mq0 = torch.where(fix0, torch.minimum(mapq_p + 7, new_mq1), new_mq0)
    new_mq1 = torch.where(fix1, torch.minimum(mapq_p + 7, new_mq0), new_mq1)
    only0 = m0 & ~m1
    only1 = m1 & ~m0
    new_sq1 = torch.where(only0, 0, sq1)
    new_mq1 = torch.where(only0, torch.minimum(mq0, mapq_p), new_mq1)
    new_sq0 = torch.where(only1, 0, sq0)
    new_mq0 = torch.where(only1, torch.minimum(mq1, mapq_p), new_mq0)
    neither = ~m0 & ~m1
    mq_n = (mapq_p - 20).clamp(min=0)
    new_sq0 = torch.where(neither, 0, new_sq0)
    new_sq1 = torch.where(neither, 0, new_sq1)
    new_mq0 = torch.where(neither, mq_n, new_mq0)
    new_mq1 = torch.where(neither, mq_n, new_mq1)

    def final_end(se, meta, ch_pos, rst, new_mq, new_sq):
        moved = found & ((se["pos"].long() != ch_pos)
                         | (se["strand"].long() != rst))
        out = dict(se)

        def upd(name, val):
            out[name] = torch.where(moved, val, se[name].long()).to(_i32)

        upd("pos", ch_pos)
        upd("strand", rst)
        upd("n_mm", meta & 63)
        upd("n_gapo", (meta >> 6) & 63)
        upd("n_gape", (meta >> 12) & 63)
        out["mapq"] = torch.where(found, new_mq, se["mapq"].long()).to(_i32)
        out["seq_q"] = torch.where(found, new_sq,
                                   se["seq_q"].long()).to(_i32)
        out["proper"] = found
        return out, moved & (out["mapq"] > 0)

    out0, chg0 = final_end(se0, meta0, ch_pos0, rst0, new_mq0, new_sq0)
    out1, chg1 = final_end(se1, meta1, ch_pos1, rst1, new_mq1, new_sq1)
    cnt_chg = (chg0.long() + chg1.long()).sum().to(_i32)
    return out0, out1, cnt_chg


# ---------------- pair status taxonomy ----------------

# status codes (device enum; the host writes the strings)
ST_PROP, ST_PARTIAL, ST_FWD, ST_REV, ST_NOTPAIR, ST_LOWQ, ST_ABNORMAL, \
    ST_DIFFCHROM = range(8)

INSERT_SIZE_LIMIT = 4096


def pair_status(tables_cid, contig_off, contig_len, n_text: int,
                se0, se1, mapped0, mapped1):
    """ProcessPairStatus (src/StatCollector.cpp:623-948) as accumulators.
    Soft clips only arise from mate rescue: rescued ends carry their
    (leading, trailing) clip widths in se["cl_l"]/se["cl_r"] (injected via
    qc_full's pe_fill; zero for kernel-mapped ends).  Returns dict of
    status (P,), actual (P,), isize_dist, dup_keys (P, 3), n_pair_reads,
    status_counts, mi, mi2, cid_p, cid_q."""
    L = lambda x: x.long()  # noqa: E731
    p_pos, q_pos = L(se0["pos"]), L(se1["pos"])
    p_str, q_str = L(se0["strand"]), L(se1["strand"])
    p_len, q_len = L(se0["len"]), L(se1["len"])
    p_mq, q_mq = L(se0["mapq"]), L(se1["mapq"])
    zz = torch.zeros_like(p_pos)
    cl1 = L(se0.get("cl_l", zz))
    cl2 = L(se0.get("cl_r", zz))
    cl3 = L(se1.get("cl_l", zz))
    cl4 = L(se1.get("cl_r", zz))
    C = contig_off.shape[0]
    cid_p = L(tables_cid[p_pos.clamp(0, n_text)])
    cid_q = L(tables_cid[q_pos.clamp(0, n_text)])
    off_p = L(contig_off[cid_p.clamp(0, C - 1)])
    len_p = L(contig_len[cid_p.clamp(0, C - 1)])
    off_q = L(contig_off[cid_q.clamp(0, C - 1)])
    len_q = L(contig_len[cid_q.clamp(0, C - 1)])

    both = mapped0 & mapped1
    single_p = mapped0 & ~mapped1
    single_q = mapped1 & ~mapped0

    def single_status(pos, strnd, ln, mq, off, cln):
        # single rows only exist when the end passed AddSingleAlignment's
        # mapQ >= 20 gate, and non-fitting mapQ>0 singles produce NO row
        # (status -1)
        rev_fit = off + cln >= pos + ln
        fwd_fit = pos >= off
        return torch.where(
            mq >= 20,
            torch.where(strnd == 1, torch.where(rev_fit, ST_REV, -1),
                        torch.where(fwd_fit, ST_FWD, -1)), -1)

    st_p = single_status(p_pos, p_str, p_len, p_mq, off_p, len_p)
    st_q = single_status(q_pos, q_str, q_len, q_mq, off_q, len_q)

    # Both: FR geometry gates (pos - leading_clip arithmetic like the host
    # collector; cl* are zero except for rescue-injected ends)
    pa = p_pos - cl1
    qa = q_pos - cl3
    fr1 = (p_str == 0) & (q_str == 1) & (p_pos < q_pos)
    fr2 = (q_str == 0) & (p_str == 1) & (q_pos < p_pos)
    mi1 = torch.where(fr1 & (pa >= off_p), off_p + len_p - pa, -1)
    mi2_1 = torch.where(fr1 & (off_q + len_q >= qa + q_len),
                        qa + q_len - off_q, -1)
    mi_2 = torch.where(fr2 & (qa >= off_q), off_q + len_q - qa, -1)
    mi2_2 = torch.where(fr2 & (off_p + len_p >= pa + p_len),
                        pa + p_len - off_p, -1)
    max_i = torch.where(fr1, mi1, torch.where(fr2, mi_2, -1))
    max_i2 = torch.where(fr1, mi2_1, torch.where(fr2, mi2_2, -1))
    max_i = max_i.clamp(max=INSERT_SIZE_LIMIT - 1)
    max_i2 = max_i2.clamp(max=INSERT_SIZE_LIMIT - 1)

    diff_contig = cid_p != cid_q
    not_fr = ~fr1 & ~fr2
    low_q = (p_mq <= 0) | (q_mq <= 0)
    start = torch.where(fr1, pa, qa)
    end = torch.where(fr1, qa + q_len, pa + p_len)
    actual = torch.where(fr1 | fr2, end - start, -1)
    no_clip = torch.where(fr1, (cl1 == 0) & (cl4 == 0),
                          (cl3 == 0) & (cl2 == 0))
    prop = (max_i != -1) & (max_i2 != -1)
    st_both = torch.where(
        not_fr | diff_contig, ST_NOTPAIR,
        torch.where(low_q, ST_LOWQ, torch.where(prop, ST_PROP, ST_PARTIAL)))
    status = torch.where(both, st_both,
                         torch.where(single_p, st_p,
                                     torch.where(single_q, st_q, -1)))

    # insert-size histogram rows: same-contig NotPair counts bin 0;
    # PropPair/PartialPair count `actual`
    take_actual = both & ~not_fr & ~diff_contig & ~low_q
    take_zero = both & ~not_fr & diff_contig
    bins = torch.where(take_actual, actual.clamp(0, INSERT_SIZE_LIMIT - 1),
                       0)
    isize_dist = torch.zeros(INSERT_SIZE_LIMIT, dtype=_i64,
                             device=p_pos.device)
    isize_dist.index_add_(0, bins, (take_actual | take_zero).long())

    # PCR-duplicate keys + pair-read counting: PropPair AND no clips
    keyv = take_actual & prop & no_clip
    sent = 0x7FFFFFFF
    dup_keys = torch.stack([torch.where(keyv, cid_p, sent),
                            torch.where(keyv, start, sent),
                            torch.where(keyv, end, sent)], 1)
    n_pair_reads = 2 * keyv.long().sum()

    st_counts = torch.zeros(8, dtype=_i64, device=p_pos.device)
    st_counts.index_add_(0, status.clamp(0, 7), (status >= 0).long())
    # single rows carry the single end's max_insert fields
    mi_s = torch.where(
        single_p, torch.where((p_str == 0) & (p_pos >= off_p),
                              off_p + len_p - p_pos, -1),
        torch.where(single_q, torch.where((q_str == 0) & (q_pos >= off_q),
                                          off_q + len_q - q_pos, -1), -1))
    mi2_s = torch.where(
        single_p, torch.where((p_str == 1) & (off_p + len_p >= p_pos + p_len),
                              p_pos + p_len - off_p, -1),
        torch.where(single_q,
                    torch.where((q_str == 1)
                                & (off_q + len_q >= q_pos + q_len),
                                q_pos + q_len - off_q, -1), -1))
    # the reported row `actual` is -1 outside the both-mapped PropPair/
    # PartialPair branch
    actual_row = torch.where(take_actual, actual, -1)
    i32 = lambda x: x.to(_i32)  # noqa: E731
    return dict(status=i32(status), actual=i32(actual_row),
                isize_dist=i32(isize_dist), dup_keys=i32(dup_keys),
                n_pair_reads=i32(n_pair_reads), status_counts=i32(st_counts),
                mi=i32(torch.where(both, max_i, mi_s)),
                mi2=i32(torch.where(both, max_i2, mi2_s)),
                cid_p=i32(cid_p), cid_q=i32(cid_q))
