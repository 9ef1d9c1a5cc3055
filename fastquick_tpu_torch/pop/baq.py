"""BAQ (Base Alignment Quality) realignment + overlapping-mate quality
tweak for the BAM pileup path.

Re-implementation of the behavior the reference's mpileup applies
(VerifyBamID/SimplePileupViewer.cpp:688 sets MPLP_REALN |
MPLP_SMART_OVERLAPS; :255-256 calls bam_prob_realn_core(b, ref, len, 3)
= apply + extended BAQ):

- ``kpa_glocal``: the probabilistic banded glocal profile-HMM of the
  BAQ paper (Li 2011, Bioinformatics 27(8):1157-8) -- forward/backward
  with per-column rescaling, then per-base MAP state and phred-scaled
  posterior error (VerifyBamID/samtools/kprobaln.c:73-247 semantics).
- ``baq_realign``: the driver around it -- band/window computation from
  the CIGAR footprint, extended-BAQ left/right-max smoothing within
  each M run, and in-place capping of base qualities
  (VerifyBamID/samtools/bam_md.c:212-327 semantics, flag=3).
- ``tweak_overlap_quality``: htslib's overlapping-mate rule -- on
  ref positions covered by both mates: same base -> first-seen read
  gets the capped sum (<=200) and the mate 0; different base -> the
  higher-quality base keeps 80% and the other is zeroed.

Written from the published algorithm and the observable behavior of the
reference; all code here is original.
"""

from __future__ import annotations

import math

import numpy as np

# HMM parameters (kpa_par_def {d=0.001, e=0.1}; emission constants)
_D = 0.001  # gap open probability
_E = 0.1    # gap extension probability
_EI = 0.25
_EM = 0.33333333333

# the C table is float (kprobaln.c:42 `static float g_qual2prob[256]`);
# the DP then promotes to double -- round through float32 first or the
# posteriors drift in the last bits (caught by the refbaq oracle)
_QUAL2PROB = np.power(10.0, -np.arange(256) / 10.0).astype(
    np.float32).astype(np.float64)


def _set_u(bw: int, i: int, k: int) -> int:
    x = i - bw
    if x < 0:
        x = 0
    return (k - x + 1) * 3


def kpa_glocal(ref: np.ndarray, query: np.ndarray, iqual: np.ndarray,
               bw_conf: int) -> tuple[np.ndarray, np.ndarray]:
    """Banded glocal HMM forward/backward + MAP.

    ref/query: uint8 codes 0..3 (4 = ambiguous).  iqual: phred quals.
    Returns (state, q): state[i] = (ref_pos << 2) | typ (typ 0 = match,
    1 = insertion; -1 if no state), q[i] = phred posterior error of
    state[i].
    """
    l_ref = len(ref)
    l_query = len(query)
    state = np.full(l_query, -1, dtype=np.int64)
    q_out = np.zeros(l_query, dtype=np.int64)
    if l_ref <= 0 or l_query <= 0:
        return state, q_out

    bw = max(l_ref, l_query)
    if bw > bw_conf:
        bw = bw_conf
    if bw < abs(l_ref - l_query):
        bw = abs(l_ref - l_query)
    bw2 = bw * 2 + 1
    W = bw2 * 3 + 6

    f = [np.zeros(W) for _ in range(l_query + 1)]
    b = [np.zeros(W) for _ in range(l_query + 1)]
    s = np.zeros(l_query + 2)
    qual = _QUAL2PROB[iqual.astype(np.int64)]

    sM = sI = 1.0 / (2 * l_query + 2)
    m = [0.0] * 9
    m[0] = (1 - _D - _D) * (1 - sM)
    m[1] = m[2] = _D * (1 - sM)
    m[3] = (1 - _E) * (1 - sI)
    m[4] = _E * (1 - sI)
    m[5] = 0.0
    m[6] = 1 - _E
    m[7] = 0.0
    m[8] = _E

    bM = (1 - _D) / l_ref
    bI = _D / l_ref

    def emis(rk: int, qy: int, ql: float) -> float:
        if rk > 3 or qy > 3:
            return 1.0
        return 1.0 - ql if rk == qy else ql * _EM

    # ---- forward ----
    f[0][_set_u(bw, 0, 0)] = s[0] = 1.0
    # f[1]
    fi = f[1]
    end1 = l_ref if l_ref < bw + 1 else bw + 1
    tot = 0.0
    for k in range(1, end1 + 1):
        e = emis(int(ref[k - 1]), int(query[0]), float(qual[0]))
        u = _set_u(bw, 1, k)
        fi[u] = e * bM
        fi[u + 1] = _EI * bI
        tot += fi[u] + fi[u + 1]
    s[1] = tot
    lo, hi = _set_u(bw, 1, 1), _set_u(bw, 1, end1) + 2
    fi[lo:hi + 1] /= tot
    # f[2..l_query]
    for i in range(2, l_query + 1):
        fi = f[i]
        fi1 = f[i - 1]
        qli = float(qual[i - 1])
        qyi = int(query[i - 1])
        beg = max(1, i - bw)
        end = min(l_ref, i + bw)
        tot = 0.0
        for k in range(beg, end + 1):
            e = emis(int(ref[k - 1]), qyi, qli)
            u = _set_u(bw, i, k)
            v11 = _set_u(bw, i - 1, k - 1)
            v10 = _set_u(bw, i - 1, k)
            v01 = _set_u(bw, i, k - 1)
            fi[u] = e * (m[0] * fi1[v11] + m[3] * fi1[v11 + 1]
                         + m[6] * fi1[v11 + 2])
            fi[u + 1] = _EI * (m[1] * fi1[v10] + m[4] * fi1[v10 + 1])
            fi[u + 2] = m[2] * fi[v01] + m[8] * fi[v01 + 2]
            tot += fi[u] + fi[u + 1] + fi[u + 2]
        s[i] = tot
        lo, hi = _set_u(bw, i, beg), _set_u(bw, i, end) + 2
        fi[lo:hi + 1] *= 1.0 / tot
    # s[l_query+1]
    tot = 0.0
    for k in range(1, l_ref + 1):
        u = _set_u(bw, l_query, k)
        if u < 3 or u >= bw2 * 3 + 3:
            continue
        tot += f[l_query][u] * sM + f[l_query][u + 1] * sI
    s[l_query + 1] = tot

    # ---- backward ----
    bi = b[l_query]
    for k in range(1, l_ref + 1):
        u = _set_u(bw, l_query, k)
        if u < 3 or u >= bw2 * 3 + 3:
            continue
        bi[u] = sM / s[l_query] / s[l_query + 1]
        bi[u + 1] = sI / s[l_query] / s[l_query + 1]
    for i in range(l_query - 1, 0, -1):
        bi = b[i]
        bi1 = b[i + 1]
        y = 1.0 if i > 1 else 0.0
        qli1 = float(qual[i])
        qyi1 = int(query[i])
        beg = max(1, i - bw)
        end = min(l_ref, i + bw)
        for k in range(end, beg - 1, -1):
            u = _set_u(bw, i, k)
            v11 = _set_u(bw, i + 1, k + 1)
            v10 = _set_u(bw, i + 1, k)
            v01 = _set_u(bw, i, k + 1)
            e = (0.0 if k >= l_ref
                 else emis(int(ref[k]), qyi1, qli1)) * bi1[v11]
            bi[u] = e * m[0] + _EI * m[1] * bi1[v10 + 1] + m[2] * bi[v01 + 2]
            bi[u + 1] = e * m[3] + _EI * m[4] * bi1[v10 + 1]
            bi[u + 2] = (e * m[6] + m[8] * bi[v01 + 2]) * y
        lo, hi = _set_u(bw, i, beg), _set_u(bw, i, end) + 2
        bi[lo:hi + 1] *= 1.0 / s[i]

    # ---- MAP per query base ----
    for i in range(1, l_query + 1):
        fi = f[i]
        bi = b[i]
        beg = max(1, i - bw)
        end = min(l_ref, i + bw)
        mx = 0.0
        max_k = -1
        tot = 0.0
        for k in range(beg, end + 1):
            u = _set_u(bw, i, k)
            z = fi[u] * bi[u]
            if z > mx:
                mx = z
                max_k = (k - 1) << 2 | 0
            tot += z
            z = fi[u + 1] * bi[u + 1]
            if z > mx:
                mx = z
                max_k = (k - 1) << 2 | 1
            tot += z
        # C: max /= sum;  k = (int)(-4.343*log(1.-max)+.499);
        #    q[i-1] = k > 100 ? 99 : k   (q is uint8)
        # When sum == 0 (no in-band state) max/sum is NaN, and when
        # max == sum exactly log(0) is -inf: the (int) cast of NaN/inf
        # is x86 cvttsd2si -> INT_MIN, which is not > 100, so the uint8
        # store yields 0.  The compiled oracle (refbaq) pins this path.
        with np.errstate(invalid="ignore"):
            mx = mx / tot if tot != 0.0 else float("nan")
        state[i - 1] = max_k
        if mx != mx or mx >= 1.0:  # NaN or log(<=0): cvttsd2si overflow
            k = -(2 ** 31)
        else:
            k = int(-4.343 * math.log(1.0 - mx) + 0.499)
        q_out[i - 1] = 99 if k > 100 else k & 0xFF
    return state, q_out


def baq_realign(pos0: int, cigar: list[tuple[str, int]], seq_codes: np.ndarray,
                qual: np.ndarray, ref_codes_fetch) -> np.ndarray | None:
    """Extended BAQ, apply mode (bam_prob_realn_core flag=3 semantics).

    pos0: 0-based alignment start; cigar: [(op, len)] with SAM ops;
    seq_codes: read nt codes (0..3, 4=N); qual: phred quals (modified
    copy returned); ref_codes_fetch(start0, end0) -> codes of the
    reference slice (clamped; 4 for N / out of contig).
    Returns the capped qual array, or None when BAQ does not apply.
    """
    l_qseq = len(seq_codes)
    if l_qseq == 0 or (len(qual) and qual[0] == 255):
        return None
    x, y = pos0, 0
    yb = ye = xb = xe = -1
    for op, ln in cigar:
        if op in ("M", "=", "X"):
            if yb < 0:
                yb = y
            if xb < 0:
                xb = x
            ye = y + ln
            xe = x + ln
            x += ln
            y += ln
        elif op in ("S", "I"):
            y += ln
        elif op == "D":
            x += ln
        elif op == "N":
            return None
    if yb < 0:
        return None
    bw = 7
    if abs((xe - xb) - (ye - yb)) > bw:
        bw = abs((xe - xb) - (ye - yb)) + 3
    xb -= yb + bw // 2
    if xb < 0:
        xb = 0
    xe += l_qseq - ye + bw // 2
    if xe - xb - l_qseq > bw:
        shrink = (xe - xb - l_qseq - bw) // 2
        xb += shrink
        xe -= shrink

    r = np.asarray(ref_codes_fetch(xb, xe), dtype=np.uint8)
    if len(r) < xe - xb:
        xe = xb + len(r)
    if xe <= xb:
        return None
    state, q = kpa_glocal(r, seq_codes, qual, bw)

    bq = qual.astype(np.int64).copy()
    left = np.zeros(l_qseq, dtype=np.int64)
    rght = np.zeros(l_qseq, dtype=np.int64)
    x, y = pos0, 0
    for op, ln in cigar:
        if op in ("M", "=", "X"):
            for i in range(y, y + ln):
                if (state[i] & 3) != 0 or (state[i] >> 2) != x - xb + (i - y):
                    bq[i] = 0
                else:
                    bq[i] = q[i]
            left[y] = bq[y]
            for i in range(y + 1, y + ln):
                left[i] = bq[i] if bq[i] > left[i - 1] else left[i - 1]
            rght[y + ln - 1] = bq[y + ln - 1]
            for i in range(y + ln - 2, y - 1, -1):
                rght[i] = bq[i] if bq[i] > rght[i + 1] else rght[i + 1]
            for i in range(y, y + ln):
                bq[i] = left[i] if left[i] < rght[i] else rght[i]
            x += ln
            y += ln
        elif op in ("S", "I"):
            y += ln
        elif op == "D":
            x += ln
    # finalize + apply: qual becomes min(qual, extended-BAQ) on M bases
    adj = np.where(qual.astype(np.int64) <= bq, 0,
                   qual.astype(np.int64) - bq)
    return (qual.astype(np.int64) - adj).astype(qual.dtype)


def _ref_walk(pos0: int, cigar: list[tuple[str, int]]):
    """Yield (ref_pos0, query_idx) for every aligned (M/=/X) base."""
    x, y = pos0, 0
    for op, ln in cigar:
        if op in ("M", "=", "X"):
            for i in range(ln):
                yield x + i, y + i
            x += ln
            y += ln
        elif op in ("S", "I"):
            y += ln
        elif op in ("D", "N"):
            x += ln


def tweak_overlap_quality(a: dict, b: dict) -> None:
    """htslib tweak_overlap_quality semantics: `a` is the mate seen
    first.  Mutates a['qarr'] / b['qarr'] (int arrays) in place."""
    a_map = {rp: qi for rp, qi in _ref_walk(a["pos"], a["cigar"])}
    for rp, bi in _ref_walk(b["pos"], b["cigar"]):
        ai = a_map.get(rp)
        if ai is None:
            continue
        aq = int(a["qarr"][ai])
        bq = int(b["qarr"][bi])
        if a["seq"][ai] == b["seq"][bi]:
            tot = aq + bq
            a["qarr"][ai] = 200 if tot > 200 else tot
            b["qarr"][bi] = 0
        else:
            if aq >= bq:
                a["qarr"][ai] = int(0.8 * aq)
                b["qarr"][bi] = 0
            else:
                a["qarr"][ai] = 0
                b["qarr"][bi] = int(0.8 * bq)
