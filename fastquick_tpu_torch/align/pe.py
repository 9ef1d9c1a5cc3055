"""Pair-end logic: insert-size inference, pair picking, mate rescue.

Equivalents of infer_isize (reference libbwa/bwape.c:49-118), pairing
(:119-215 with the __pairing_aux/__pairing_aux2 macros, bwape.h:55-85),
bwa_sw_core (:359-445) and bwa_paired_sw (:463-), operating on unpacked
text codes.  The SA-interval -> position cache (khash g_hash keyed on
k<<32|l for intervals wider than MIN_HASH_WIDTH, src/BwtMapper.cpp:~810)
is modeled as a plain dict, including its first-seen-read-length caching
behavior for reverse-strand positions.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..index.fmindex import FMIndex
from .core import Aln
from .dp import FROM_D, FROM_I, FROM_M, FROM_S, local_align
from .opts import (
    BWA_TYPE_MATESW,
    BWA_TYPE_NO_MATCH,
    G_LOG_N,
    SAM_FPP,
    SW_MIN_MAPQ,
    SW_MIN_MATCH_LEN,
    PeOpt,
)
from .seqs import Read, seq_reverse

MIN_HASH_WIDTH = 1000
OUTLIER_BOUND = 2.0


@dataclass
class IsizeInfo:
    avg: float = -1.0
    std: float = -1.0
    ap_prior: float = 0.0
    low: int = 0
    high: int = 0
    high_bayesian: int = 0


def sa_pos(fms: tuple[FMIndex, FMIndex], strand: int, row: int, length: int) -> int:
    """SA row -> pac position: forward SA for strand 1, reverse-index
    conversion for strand 0 (bwa_cal_pac_pos_pe, src/BwtMapper.cpp:769-774).
    Our full SA makes this a single lookup."""
    if strand:
        return int(fms[0].sa[row])
    return fms[1].n - (int(fms[1].sa[row]) + length)


def hash_64(key: int) -> int:
    key &= 0xFFFFFFFFFFFFFFFF

    def u64(x):
        return x & 0xFFFFFFFFFFFFFFFF

    key = u64(key + u64(~u64(key << 32)))
    key ^= key >> 22
    key = u64(key + u64(~u64(key << 13)))
    key ^= key >> 8
    key = u64(key + u64(key << 3))
    key ^= key >> 15
    key = u64(key + u64(~u64(key << 27)))
    key ^= key >> 31
    return key


def infer_isize(pairs: list[tuple[Read, Read]], ii: IsizeInfo,
                ap_prior: float, l_pac: int) -> int:
    """bwape.c:49-118."""
    ii.avg = ii.std = -1.0
    ii.low = ii.high = ii.high_bayesian = 0
    isizes = []
    max_len = 1
    for p0, p1 in pairs:
        if p0.mapQ >= 20 and p1.mapQ >= 20:
            if p0.pos < p1.pos:
                x = p1.pos + p1.len - p0.pos
            else:
                x = p0.pos + p0.len - p1.pos
            if x < 100000:
                isizes.append(x)
        max_len = max(max_len, p0.len, p1.len)
    tot = len(isizes)
    if tot < 20:
        return -1
    isizes.sort()
    p25 = isizes[int(tot * 0.25 + 0.5)]
    p75 = isizes[int(tot * 0.75 + 0.5)]
    tmp = int(p25 - OUTLIER_BOUND * (p75 - p25) + 0.499)
    ii.low = tmp if tmp > max_len else max_len
    ii.high = int(p75 + OUTLIER_BOUND * (p75 - p25) + 0.499)
    xs = [v for v in isizes if ii.low <= v <= ii.high]
    n = len(xs)
    ii.avg = sum(xs) / n
    # C quirk (bwape.c:85,88): ii->std is initialized to -1.0 at the top
    # and the variance loop accumulates into it WITHOUT zeroing first, so
    # the reference's variance sum is (sum of squares) - 1.0.  Verified
    # against the compiled reference by tests/test_ref_differential.py.
    var = -1.0 + sum((v - ii.avg) ** 2 for v in xs)
    ii.std = math.sqrt(var / n)
    y = 1.0
    while y < 10.0:
        if 0.5 * math.erfc(y / math.sqrt(2)) < ap_prior / l_pac * (y * ii.std + ii.avg):
            break
        y += 0.01
    ii.high_bayesian = int(y * ii.std + ii.avg + 0.499)
    n_ap = sum(1 for v in isizes if v > ii.high_bayesian)
    ii.ap_prior = 0.01 * (n_ap + 0.01) / tot
    if ii.ap_prior < ap_prior:
        ii.ap_prior = ap_prior
    if math.isnan(ii.std) or p75 > 100000:
        ii.low = ii.high = ii.high_bayesian = 0
        ii.avg = ii.std = -1.0
        return -1
    y = 1.0
    while y < 10.0:
        if 0.5 * math.erfc(y / math.sqrt(2)) < ap_prior / l_pac * (y * ii.std + ii.avg):
            break
        y += 0.01
    ii.high_bayesian = int(y * ii.std + ii.avg + 0.499)
    return 0


def infer_isize_from_hist_f64(hist, max_len: int, ap_prior: float,
                              l_pac: int) -> IsizeInfo:
    """infer_isize (bwape.c:49-118) in float64 from an EXACT integer
    isize histogram (the device's psum'd `_isize_hist`): the product
    recipe for host-side mate rescue over device batches -- the window
    math then bit-matches the host pipeline's own inference (the f32
    on-device `_ii` is only used inside the device pairing sweep)."""
    import numpy as _np

    ii = IsizeInfo()
    ii.ap_prior = ap_prior
    hist = _np.asarray(hist, _np.int64)
    tot = int(hist.sum())
    if tot < 20:
        return ii
    cum = _np.cumsum(hist)

    def q_at(idx):
        # sorted[idx] (0-based) = smallest v with cum(v) >= idx + 1
        return int(_np.argmax(cum >= idx + 1))

    p25 = q_at(int(tot * 0.25 + 0.5))
    p75 = q_at(int(tot * 0.75 + 0.5))
    tmp = int(p25 - OUTLIER_BOUND * (p75 - p25) + 0.499)
    ii.low = tmp if tmp > max_len else max_len
    ii.high = int(p75 + OUTLIER_BOUND * (p75 - p25) + 0.499)
    v = _np.arange(hist.shape[0], dtype=_np.int64)
    in_win = (v >= ii.low) & (v <= ii.high)
    hw = hist[in_win]
    vw = v[in_win]
    n = int(hw.sum())
    ii.avg = float((hw * vw).sum()) / n
    # C quirk: the variance accumulator starts at -1.0 (bwape.c:85-88)
    var = -1.0 + float((hw * (vw - ii.avg) ** 2).sum())
    ii.std = math.sqrt(var / n)
    y = 1.0
    while y < 10.0:
        if 0.5 * math.erfc(y / math.sqrt(2)) \
                < ap_prior / l_pac * (y * ii.std + ii.avg):
            break
        y += 0.01
    ii.high_bayesian = int(y * ii.std + ii.avg + 0.499)
    n_ap = int(hist[v > ii.high_bayesian].sum())
    ii.ap_prior = 0.01 * (n_ap + 0.01) / tot
    if ii.ap_prior < ap_prior:
        ii.ap_prior = ap_prior
    if math.isnan(ii.std) or p75 > 100000:
        ii.low = ii.high = ii.high_bayesian = 0
        ii.avg = ii.std = -1.0
    return ii


def pairing(p: list[Read], alns: list[list[Aln]], arr: list[int],
            opt: PeOpt, s_mm: int, ii: IsizeInfo) -> int:
    """bwape.c:119-215 (BWA_PET_STD only).  arr entries are
    pos<<32 | aln_index<<1 | end, pre-sorted."""
    cnt_chg = 0
    max_len = max(p[0].full_len, p[1].full_len)

    o_score = sub_score = (1 << 64) - 1
    o_n = subo_n = 0
    o_pos = [None, None]
    last_pos = [[None, None], [None, None]]
    U64MAX = (1 << 64) - 1
    arr = sorted(arr)

    def pairing_aux(u, v):
        nonlocal o_score, sub_score, o_n, subo_n, o_pos
        if u is None:
            return
        l = (v >> 32) + p[v & 1].len - (u >> 32)
        if (v >> 32 > u >> 32 and l >= max_len
                and ((ii.high and l <= ii.high_bayesian)
                     or (ii.high == 0 and l <= opt.max_isize))):
            s = (alns[v & 1][(v & 0xFFFFFFFF) >> 1].score
                 + alns[u & 1][(u & 0xFFFFFFFF) >> 1].score)
            s *= 10
            if ii.high:
                # C float semantics: std can be 0 (degenerate isize
                # distribution) -> inf/nan ratio; the (int) cast of the
                # resulting inf/nan is INT_MIN on x86
                with np.errstate(divide="ignore", invalid="ignore"):
                    ratio = np.float64(abs(l - ii.avg)) / np.float64(ii.std)
                    v_pen = (-4.343 * np.log(0.5 * math.erfc(
                        float(ratio) / math.sqrt(2))) + 0.499
                        if not np.isnan(ratio) else float("nan"))
                if math.isnan(v_pen) or math.isinf(v_pen):
                    s += -(2 ** 31)
                else:
                    s += int(v_pen)
            s = ((s << 32) | hash_64(((u >> 32) << 32) | (v >> 32))) & U64MAX
            if s >> 32 == o_score >> 32:
                o_n += 1
            elif s >> 32 < ((o_score << 32) & U64MAX):
                # NB: reference compares against o_score<<32 (bwape.h:68),
                # faithfully reproduced
                subo_n += o_n
                o_n = 1
            else:
                subo_n += 1
            if s < o_score:
                sub_score = o_score
                o_score = s
                o_pos[u & 1] = u
                o_pos[v & 1] = v
            elif s < sub_score:
                sub_score = s

    for x in arr:
        strand = alns[x & 1][(x & 0xFFFFFFFF) >> 1].a
        if strand == 1:
            y = 1 - (x & 1)
            pairing_aux(last_pos[y][1], x)
            pairing_aux(last_pos[y][0], x)
        else:
            last_pos[x & 1][0] = last_pos[x & 1][1]
            last_pos[x & 1][1] = x

    if o_score != U64MAX:
        mapQ_p = 0
        if o_n == 1:
            if sub_score == U64MAX:
                mapQ_p = 29
            elif (sub_score >> 32) - (o_score >> 32) > s_mm * 10:
                mapQ_p = 23
            else:
                n = subo_n if subo_n <= 255 else 255
                mapQ_p = ((sub_score >> 32) - (o_score >> 32)) // 2 - G_LOG_N[n]
                if mapQ_p < 0:
                    mapQ_p = 0
        rr = [alns[o_pos[0] & 1][(o_pos[0] & 0xFFFFFFFF) >> 1].a,
              alns[o_pos[1] & 1][(o_pos[1] & 0xFFFFFFFF) >> 1].a]
        m0 = p[0].pos == o_pos[0] >> 32 and p[0].strand == rr[0]
        m1 = p[1].pos == o_pos[1] >> 32 and p[1].strand == rr[1]
        if m0 and m1:
            if p[0].mapQ > 0 and p[1].mapQ > 0:
                mq = min(p[0].mapQ + p[1].mapQ, 60)
                p[0].mapQ = p[1].mapQ = mq
            else:
                if p[0].mapQ == 0:
                    p[0].mapQ = min(mapQ_p + 7, p[1].mapQ)
                if p[1].mapQ == 0:
                    p[1].mapQ = min(mapQ_p + 7, p[0].mapQ)
        elif m0:
            p[1].seQ = 0
            p[1].mapQ = min(p[0].mapQ, mapQ_p)
        elif m1:
            p[0].seQ = 0
            p[0].mapQ = min(p[1].mapQ, mapQ_p)
        else:
            p[0].seQ = p[1].seQ = 0
            mapQ_p = max(mapQ_p - 20, 0)
            p[0].mapQ = p[1].mapQ = mapQ_p

        for j in (0, 1):
            w = o_pos[j]
            r = alns[w & 1][(w & 0xFFFFFFFF) >> 1]
            q = p[j]
            q.extra_flag |= SAM_FPP
            if q.pos != w >> 32 or q.strand != r.a:
                q.n_mm = r.n_mm
                q.n_gapo = r.n_gapo
                q.n_gape = r.n_gape
                q.strand = r.a
                q.score = r.score
                q.pos = w >> 32
                if q.mapQ > 0:
                    cnt_chg += 1
    return cnt_chg


def _sw_precheck(text: np.ndarray, length: int, seq: np.ndarray, beg: int,
                 reglen: int) -> bool:
    """The cheap rejection gates at the top of bwa_sw_core
    (bwape.c:366-375); shared with the batched path so only jobs that
    will actually run SW are submitted."""
    l_pac = len(text)
    if reglen < SW_MIN_MATCH_LEN or l_pac - beg < length:
        return False
    n_n = int(np.count_nonzero(seq[:length] > 3))
    return not (n_n / length >= 0.25 or length - n_n < SW_MIN_MATCH_LEN)


def bwa_sw_core(text: np.ndarray, length: int, seq: np.ndarray, beg: int,
                reglen: int, precomputed=None) -> tuple[list | None, int, int]:
    """Mate rescue local SW (bwape.c:359-445).
    Returns (cigar | None, new_beg, cnt) with cnt = n_mm<<16|n_gapo<<8|n_gape.
    `precomputed` optionally carries this job's (score, cigar, coords)
    from a batched native sw_local run (identical results)."""
    l_pac = len(text)
    if not _sw_precheck(text, length, seq, beg, reglen):
        return None, beg, 0

    hi = min(beg + reglen, l_pac)
    ref_seq = text[beg:hi]
    if precomputed is None:
        score, cigar, coords = local_align(ref_seq, seq[:length], thres=1)
    else:
        score, cigar, coords = precomputed
    if score < 0 or not cigar:
        return None, beg, 0
    si, sj, ei, ej, bi, bj = coords

    x = y = 0
    for op, ln in cigar:
        if op == FROM_M:
            x += ln
            y += ln
        elif op == FROM_D:
            x += ln
        else:
            y += ln
    if x < SW_MIN_MATCH_LEN or y < SW_MIN_MATCH_LEN:
        return None, beg, 0

    # update cigar and coordinate; the path's begin entry shifted to the
    # full matrix is (bi + si - 1, bj + sj - 1)
    pl_i = bi + si - 1
    pl_j = bj + sj - 1
    new_beg = beg + (pl_i if pl_i else 1) - 1
    start = (pl_j if pl_j else 1) - 1
    end = ej
    if start:
        cigar = [(FROM_S, start)] + cigar
    if end < length:
        cigar = cigar + [(FROM_S, length - end)]

    # count mismatches/gaps (uses region-local coordinates)
    n_mm = n_gapo = n_gape = 0
    x = pl_i - 1 if pl_i else 0
    y = pl_j - 1 if pl_j else 0
    for op, ln in cigar:
        if op == FROM_M:
            a = ref_seq[x:x + ln]
            b = seq[y:y + ln]
            n_mm += int(np.count_nonzero((a < 4) & (b < 4) & (a != b)))
            x += ln
            y += ln
        elif op == FROM_D:
            x += ln
            n_gapo += 1
            n_gape += ln - 1
        elif op == FROM_I:
            y += ln
            n_gapo += 1
            n_gape += ln - 1
    cnt = (n_mm << 16) | (n_gapo << 8) | n_gape
    return cigar, new_beg, cnt


def expand_seq(p: Read, q: Read, mode: int) -> None:
    """bwape.c expand_seq: un-filter a read because its mate is mapped."""
    from .opts import BWA_MODE_COMPREAD

    is_comp = bool(mode & BWA_MODE_COMPREAD)
    codes = p.seq[: p.len].copy()  # forward codes (filtered => not reversed)
    p.rseq = seq_reverse(codes, is_comp)
    p.seq = np.concatenate([seq_reverse(codes, False), p.seq[p.len:]])
    p.name = q.name
    p.filtered = False


def _batch_local_sw(text: np.ndarray, todo: list, device=None,
                    device_sw: bool = False) -> dict:
    """Run every precheck-passing mate-rescue SW window through the
    threaded native sw_local_batch -- or, with `device_sw` (the align
    driver's device-QC mode), through the CUDA SW kernel on `device`
    ("cuda" when None; ops/sw_kernels.sw_local_batch_device: fwd+rev DP
    passes on the device with the exact freeze-F recurrence, host global
    path), which is pinned result-identical to the native/host path.
    Returns {(pair_idx, k): (score, cigar, coords)}; empty dict when
    neither fast path is available (bwa_sw_core then computes each job
    itself)."""
    from ..native import get_sw_lib

    if device_sw and todo:
        from ..ops.sw_kernels import sw_local_batch_device

        l_pac = len(text)
        keys = []
        jobs = []
        for idx, (p, pjobs) in enumerate(todo):
            for k in (0, 1):
                if pjobs[k] is None:
                    continue
                a, b, seq = pjobs[k]
                length = p[k].len
                if not _sw_precheck(text, length, seq, a, b - a):
                    continue
                keys.append((idx, k))
                jobs.append((np.ascontiguousarray(
                    text[a:min(b, l_pac)], dtype=np.uint8),
                    np.ascontiguousarray(seq[:length], dtype=np.uint8)))
        res = sw_local_batch_device(
            jobs, "cuda" if device is None else str(device))
        return {key: res[i] for i, key in enumerate(keys)}

    lib = get_sw_lib()
    if lib is None or not todo:
        return {}
    import ctypes
    import os as _os

    l_pac = len(text)
    keys = []
    refs = []
    qs = []
    for idx, (p, jobs) in enumerate(todo):
        for k in (0, 1):
            if jobs[k] is None:
                continue
            a, b, seq = jobs[k]
            length = p[k].len
            if not _sw_precheck(text, length, seq, a, b - a):
                continue
            keys.append((idx, k))
            refs.append(np.ascontiguousarray(text[a:min(b, l_pac)],
                                             dtype=np.uint8))
            qs.append(np.ascontiguousarray(seq[:length], dtype=np.uint8))
    if not keys:
        return {}
    n = len(keys)
    ref_len = np.array([len(r) for r in refs], dtype=np.int32)
    q_len = np.array([len(q) for q in qs], dtype=np.int32)
    ref_off = np.zeros(n, dtype=np.int64)
    ref_off[1:] = np.cumsum(ref_len[:-1], dtype=np.int64)
    q_off = np.zeros(n, dtype=np.int64)
    q_off[1:] = np.cumsum(q_len[:-1], dtype=np.int64)
    ref_buf = np.concatenate(refs)
    q_buf = np.concatenate(qs)
    cig_cap = int((ref_len + q_len).max()) + 2
    scores = np.zeros(n, dtype=np.int64)
    coords = np.zeros(6 * n, dtype=np.int32)
    cigars = np.zeros(n * cig_cap, dtype=np.uint32)
    ncig = np.zeros(n, dtype=np.int32)
    cp = ctypes.c_void_p
    lib.sw_local_batch(
        ref_buf.ctypes.data_as(cp), ref_off.ctypes.data_as(cp),
        ref_len.ctypes.data_as(cp), q_buf.ctypes.data_as(cp),
        q_off.ctypes.data_as(cp), q_len.ctypes.data_as(cp), n, 1,
        scores.ctypes.data_as(cp), coords.ctypes.data_as(cp),
        cigars.ctypes.data_as(cp), cig_cap, ncig.ctypes.data_as(cp),
        min(8, _os.cpu_count() or 1))
    out = {}
    for i, key in enumerate(keys):
        nc = int(ncig[i])
        cig = ([(int(c >> 28), int(c & 0x0FFFFFFF))
                for c in cigars[i * cig_cap:i * cig_cap + nc]]
               if nc > 0 else [])
        out[key] = (int(scores[i]), cig,
                    tuple(int(x) for x in coords[6 * i:6 * i + 6]))
    return out


def bwa_paired_sw(text: np.ndarray, pairs: list[tuple[Read, Read]],
                  popt: PeOpt, ii: IsizeInfo, mode: int,
                  device=None, device_sw: bool = False) -> None:
    """bwape.c:463-: mate rescue via local SW in the expected window;
    with `device_sw` the SW kernel runs on `device` (_batch_local_sw)."""
    if not popt.is_sw or ii.avg < 0.0:
        return
    l_pac = len(text)

    # Phase 1 (bwape.c:476-506): per-pair gates + SW window geometry.
    # Pairs are independent, so every window is known before any SW runs.
    todo: list = []  # (p, jobs) with jobs[k] = (a, b, seq) | None
    for p0, p1 in pairs:
        p = [p0, p1]
        if p[0].filtered:
            if p[1].filtered:
                continue
            expand_seq(p[0], p[1], mode)
        elif p[1].filtered:
            expand_seq(p[1], p[0], mode)

        if not ((p[0].mapQ >= SW_MIN_MAPQ or p[1].mapQ >= SW_MIN_MAPQ)
                and (p[0].extra_flag & SAM_FPP) == 0):
            continue
        jobs: list = [None, None]
        for k in (0, 1):
            if p[1 - k].type == BWA_TYPE_NO_MATCH:
                continue
            if p[1 - k].strand == 0:  # mate on reverse strand, right side
                a = int(p[1 - k].pos + ii.avg - 3 * ii.std - p[k].len * 1.5)
                b = a + int(6 * ii.std + 2 * p[k].len)
                if a < p[1 - k].pos + p[1 - k].len:
                    a = p[1 - k].pos + p[1 - k].len
                if b > l_pac:
                    b = l_pac
                seq = p[k].rseq
            else:  # mate on forward strand, left side
                a = int(p[1 - k].pos + p[1 - k].len - ii.avg - 3 * ii.std
                        - p[k].len * 0.5)
                b = a + int(6 * ii.std + 2 * p[k].len)
                if a < 0:
                    a = 0
                if b > p[1 - k].pos:
                    b = p[1 - k].pos
                seq = p[k].seq[: p[k].len][::-1]  # un-reverse to forward
            jobs[k] = (a, b, seq)
        todo.append((p, jobs))

    # Phase 2: one threaded native sw_local pass over every window
    # (results identical to the per-pair calls; {} without the native lib).
    pre = _batch_local_sw(text, todo, device, device_sw)

    # Phase 3 (bwape.c:508-560): exact per-pair selection/update order.
    for idx, (p, jobs) in enumerate(todo):
        cigar: list = [None, None]
        beg = [0, 0]
        end = [0, 0]
        cnt = [0, 0]
        mq_adjust = [255, 255]
        for k in (0, 1):
            if jobs[k] is None:
                continue
            a, b, seq = jobs[k]
            beg[k], end[k] = a, b
            cg, nb, ct = bwa_sw_core(text, p[k].len, seq, a, b - a,
                                     precomputed=pre.get((idx, k)))
            beg[k] = nb
            cnt[k] = ct
            cigar[k] = cg
            if cg is not None and p[k].type != BWA_TYPE_NO_MATCH:
                clip = 0
                if cg[0][0] == FROM_S:
                    clip += cg[0][1]
                if cg[-1][0] == FROM_S:
                    clip += cg[-1][1]
                s_old = int((p[k].n_mm * 9 + p[k].n_gapo * 13
                             + p[k].n_gape * 2) / 3.0 * 8.0 + 0.499)
                s_new = int(((ct >> 16) * 9 + ((ct >> 8) & 0xFF) * 13
                             + (ct & 0xFF) * 2 + clip * 3) / 3.0 * 8.0 + 0.499)
                s_old += int(-4.343 * math.log(ii.ap_prior / l_pac))
                s_new += int(-4.343 * math.log(0.5 * math.erfc(
                    (1 / math.sqrt(2)) * 1.5) + 0.499))
                if s_old < s_new:
                    mq_adjust[k] = s_new - s_old
                    cigar[k] = None
                else:
                    mq_adjust[k] = s_old - s_new

        k = -1
        mapQ = 0
        if cigar[0] is not None and cigar[1] is not None:
            k = 0 if p[0].mapQ < p[1].mapQ else 1
            mapQ = abs(p[1].mapQ - p[0].mapQ)
        elif cigar[0] is not None:
            k = 0
            mapQ = p[1].mapQ
        elif cigar[1] is not None:
            k = 1
            mapQ = p[0].mapQ
        if k >= 0 and p[k].pos != beg[k]:
            tmp = p[1 - k].mapQ - p[k].mapQ // 2 - 8
            if tmp <= 0:
                tmp = 1
            if mapQ > tmp:
                mapQ = tmp
            p[k].mapQ = p[1 - k].mapQ = mapQ
            p[k].seQ = p[1 - k].seQ = min(p[1 - k].seQ, mapQ)
            if p[k].mapQ > mq_adjust[k]:
                p[k].mapQ = mq_adjust[k]
            if p[k].seQ > mq_adjust[k]:
                p[k].seQ = mq_adjust[k]
            p[k].cigar = cigar[k]
            p[k].n_cigar = len(cigar[k])
            # __set_fixed
            p[k].type = BWA_TYPE_MATESW
            p[k].pos = beg[k]
            p[k].seQ = p[1 - k].seQ
            p[k].strand = 1 - p[1 - k].strand
            p[k].n_mm = cnt[k] >> 16
            p[k].n_gapo = (cnt[k] >> 8) & 0xFF
            p[k].n_gape = cnt[k] & 0xFF
            p[k].extra_flag |= SAM_FPP
            p[1 - k].extra_flag |= SAM_FPP
