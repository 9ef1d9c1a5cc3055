"""Dynamic-programming aligners (host reference engine).

Faithful equivalents of stdaln's banded global aligner (aln_global_core,
reference libbwa/stdaln.c:345-528, with the set_M/set_I/set_D tie-breaking
of stdaln.c:260-318), the local aligner used for mate rescue
(aln_local_core, stdaln.c:529-745: unbanded forward/reverse local DP to
locate the matched region, then the banded global aligner for the path),
and aln_path2cigar (FROM_M/I/D/S codes).  Scoring: aln_param_bwa =
{gap_open 26, gap_ext 9, gap_end 5, aln_sm_maq (match 11 / mismatch -19 /
vs-N -13), band_width 50} (stdaln.c:206-227).

The TPU engine replaces the local DP with a Pallas banded SW kernel; this
module remains the behavioral oracle.
"""

from __future__ import annotations

import numpy as np

FROM_M, FROM_I, FROM_D, FROM_S = 0, 1, 2, 3

ALN_SM_MAQ = np.array([
    [11, -19, -19, -19, -13],
    [-19, 11, -19, -19, -13],
    [-19, -19, 11, -19, -13],
    [-19, -19, -19, 11, -13],
    [-13, -13, -13, -13, -13],
], dtype=np.int64)

GAP_OPEN, GAP_EXT, GAP_END, BAND_WIDTH = 26, 9, 5, 50

MINOR_INF = -1073741823  # stdaln.h MINOR_INF


def aln_global_core(seq1: np.ndarray, seq2: np.ndarray,
                    band_width: int = BAND_WIDTH
                    ) -> tuple[int, list[tuple[int, int, int]]]:
    """Banded global alignment of ref seq1 vs read seq2.

    Returns (score, path) where path is [(ctype, i, j), ...] from the end
    (i=1-based ref index, j=1-based read index), matching aln_global_core's
    backtrace output (stdaln.c:489-515).

    Implemented as a full DP with band masking: cells outside BWA's band
    [j - b2 + 1, j + b1 - 1] stay at MINOR_INF, which reproduces the banded
    recursion exactly (the band edges use gap_end via set_end_I/set_end_D,
    also reproduced).
    """
    len1, len2 = len(seq1), len(seq2)
    if len1 == 0 or len2 == 0:
        return 0, []
    b = band_width
    if len1 > len2:
        b1, b2 = len1 - len2 + b, b
    else:
        b1, b2 = b, len2 - len1 + b
    b1 = min(b1, len1)
    b2 = min(b2, len2)

    NEG = MINOR_INF
    M = np.full((len2 + 1, len1 + 1), NEG, dtype=np.int64)
    I = np.full((len2 + 1, len1 + 1), NEG, dtype=np.int64)
    D = np.full((len2 + 1, len1 + 1), NEG, dtype=np.int64)
    Mt = np.zeros((len2 + 1, len1 + 1), dtype=np.int8)
    It = np.zeros((len2 + 1, len1 + 1), dtype=np.int8)
    Dt = np.zeros((len2 + 1, len1 + 1), dtype=np.int8)

    M[0, 0] = 0
    # first row: D moves along i with gap_end (set_end_D, stdaln.c:396-399)
    for i in range(1, b1):
        prev_m, prev_d = M[0, i - 1], D[0, i - 1]
        if prev_m - GAP_OPEN > prev_d:
            Dt[0, i] = FROM_M
            D[0, i] = prev_m - GAP_OPEN - GAP_END
        else:
            Dt[0, i] = FROM_D
            D[0, i] = prev_d - GAP_END

    for j in range(1, len2 + 1):
        lo = max(0, j - b2)
        hi = min(len1, j + b1 - 1)
        # column start: I from above at i == lo when lo == j - b2 is the
        # band edge; BWA uses set_end_I at i = j - b2 boundary cell only
        # for the first rows (i == 0); interior band starts are SET_INF.
        if lo == 0:
            pm, pi = M[j - 1, 0], I[j - 1, 0]
            if pm - GAP_OPEN > pi:
                It[j, 0] = FROM_M
                I[j, 0] = pm - GAP_OPEN - GAP_END
            else:
                It[j, 0] = FROM_I
                I[j, 0] = pi - GAP_END
        mat = ALN_SM_MAQ[seq2[j - 1]]
        for i in range(max(1, lo if lo > 0 else 1), hi + 1):
            # set_M from (j-1, i-1)
            pm, pi, pd = M[j - 1, i - 1], I[j - 1, i - 1], D[j - 1, i - 1]
            sc = int(mat[seq1[i - 1]])
            if pm >= pi:
                if pm >= pd:
                    M[j, i] = pm + sc
                    Mt[j, i] = FROM_M
                else:
                    M[j, i] = pd + sc
                    Mt[j, i] = FROM_D
            else:
                if pi > pd:
                    M[j, i] = pi + sc
                    Mt[j, i] = FROM_I
                else:
                    M[j, i] = pd + sc
                    Mt[j, i] = FROM_D
            # set_I from (j-1, i): vertical; at the last ref column use
            # gap_end (set_end_I), and at the band's right edge I is -inf
            pm, pi = M[j - 1, i], I[j - 1, i]
            at_right_edge = (i == hi and i != len1)
            use_end = (i == len1)
            if at_right_edge:
                I[j, i] = NEG
            elif use_end:
                if pm - GAP_OPEN > pi:
                    It[j, i] = FROM_M
                    I[j, i] = pm - GAP_OPEN - GAP_END
                else:
                    It[j, i] = FROM_I
                    I[j, i] = pi - GAP_END
            else:
                if pm - GAP_OPEN > pi:
                    It[j, i] = FROM_M
                    I[j, i] = pm - GAP_OPEN - GAP_EXT
                else:
                    It[j, i] = FROM_I
                    I[j, i] = pi - GAP_EXT
            # set_D from (j, i-1): horizontal; last read row uses gap_end
            pm, pd = M[j, i - 1], D[j, i - 1]
            if j == len2:
                if pm - GAP_OPEN > pd:
                    Dt[j, i] = FROM_M
                    D[j, i] = pm - GAP_OPEN - GAP_END
                else:
                    Dt[j, i] = FROM_D
                    D[j, i] = pd - GAP_END
            else:
                if pm - GAP_OPEN > pd:
                    Dt[j, i] = FROM_M
                    D[j, i] = pm - GAP_OPEN - GAP_EXT
                else:
                    Dt[j, i] = FROM_D
                    D[j, i] = pd - GAP_EXT

    # backtrace from (len2, len1)
    i, j = len1, len2
    mx = M[j, i]
    typ = Mt[j, i]
    ctype = FROM_M
    if I[j, i] > mx:
        mx = I[j, i]
        typ = It[j, i]
        ctype = FROM_I
    if D[j, i] > mx:
        mx = D[j, i]
        typ = Dt[j, i]
        ctype = FROM_D
    path = [(int(ctype), i, j)]
    while i or j:
        if ctype == FROM_M:
            i -= 1
            j -= 1
        elif ctype == FROM_I:
            j -= 1
        else:
            i -= 1
        ctype = typ
        if ctype == FROM_M:
            typ = Mt[j, i]
        elif ctype == FROM_I:
            typ = It[j, i]
        else:
            typ = Dt[j, i]
        path.append((int(ctype), i, j))
    # C stores path entries and reports path_len = count - 1 (drops the
    # final (0,0) sentinel entry)
    return int(mx), path[:-1]


def global_cigar(seq1: np.ndarray, seq2: np.ndarray) -> list[tuple[int, int]]:
    """Banded global alignment -> cigar; native fast path when available."""
    from ..native import get_sw_lib

    lib = get_sw_lib()
    if lib is None or len(seq1) == 0 or len(seq2) == 0:
        _, path = aln_global_core(seq1, seq2)
        return aln_path2cigar(path)
    import ctypes

    r = np.ascontiguousarray(seq1, dtype=np.uint8)
    q = np.ascontiguousarray(seq2, dtype=np.uint8)
    cap = len(seq1) + len(seq2) + 2
    cig = np.zeros(cap, dtype=np.uint32)
    n = ctypes.c_int(0)
    cp = ctypes.c_void_p
    lib.sw_global(r.ctypes.data_as(cp), len(r), q.ctypes.data_as(cp), len(q),
                  cig.ctypes.data_as(cp), cap, ctypes.byref(n))
    return [(int(c >> 28), int(c & 0x0FFFFFFF)) for c in cig[: n.value]]


def local_align(seq1: np.ndarray, seq2: np.ndarray, thres: int = 1):
    """Local alignment for mate rescue: returns
    (score, cigar, (start_i, start_j, end_i, end_j, begin_pi, begin_pj))
    with 1-based coords; empty cigar when score < thres / no match.
    Native fast path when available; python fallback derives the same
    tuple from aln_local_core's shifted path."""
    from ..native import get_sw_lib

    lib = get_sw_lib()
    if lib is not None and len(seq1) and len(seq2):
        import ctypes

        r = np.ascontiguousarray(seq1, dtype=np.uint8)
        q = np.ascontiguousarray(seq2, dtype=np.uint8)
        cap = len(seq1) + len(seq2) + 2
        cig = np.zeros(cap, dtype=np.uint32)
        coords = np.zeros(6, dtype=np.int32)
        n = ctypes.c_int(0)
        cp = ctypes.c_void_p
        score = lib.sw_local(r.ctypes.data_as(cp), len(r),
                             q.ctypes.data_as(cp), len(q), thres,
                             coords.ctypes.data_as(cp),
                             cig.ctypes.data_as(cp), cap, ctypes.byref(n))
        cigar = [(int(c >> 28), int(c & 0x0FFFFFFF)) for c in cig[: n.value]]
        return int(score), cigar, tuple(int(x) for x in coords)
    score, path, (si, sj, ei, ej) = aln_local_core(seq1, seq2, thres)
    if not path:
        return score, [], (si, sj, ei, ej, 0, 0)
    cigar = aln_path2cigar(path)
    # path entries are shifted by (start-1); recover region-local begin
    bi = path[-1][1] - (si - 1)
    bj = path[-1][2] - (sj - 1)
    return score, cigar, (si, sj, ei, ej, bi, bj)


def aln_path2cigar(path: list[tuple[int, int, int]]) -> list[tuple[int, int]]:
    """stdaln aln_path2cigar32: path (end->begin) to [(op, len)] begin->end."""
    if not path:
        return []
    ops: list[tuple[int, int]] = []
    last_type = path[0][0]
    length = 1
    for ctype, _, _ in path[1:]:
        if ctype == last_type:
            length += 1
        else:
            ops.append((last_type, length))
            last_type = ctype
            length = 1
    ops.append((last_type, length))
    ops.reverse()
    return ops


def aln_local_core(seq1: np.ndarray, seq2: np.ndarray, thres: int = 1
                   ) -> tuple[int, list[tuple[int, int, int]],
                              tuple[int, int, int, int]]:
    """Local alignment (aln_local_core, stdaln.c:529-745).

    Forward pass finds (end_i, end_j) and score; reverse pass finds
    (start_i, start_j); the path comes from the banded global aligner on
    the matched region (exactly what the C code does).

    Returns (score, path, (start_i, start_j, end_i, end_j)); score < thres
    or empty region yields (score, [], ...).  Coordinates are 1-based.
    """
    len1, len2 = len(seq1), len(seq2)
    if len1 == 0 or len2 == 0:
        return -1, [], (0, 0, 0, 0)
    sm = ALN_SM_MAQ
    q, r = GAP_OPEN, GAP_EXT
    qr = q + r

    def forward_pass(s1, s2):
        n1, n2 = len(s1), len(s2)
        h_prev = np.zeros(n1 + 1, dtype=np.int64)
        e_prev = np.zeros(n1 + 1, dtype=np.int64)
        best = 0
        bi = bj = 0
        for j in range(1, n2 + 1):
            score_col = sm[s2[j - 1]]
            h_curr = np.zeros(n1 + 1, dtype=np.int64)
            e_curr = np.zeros(n1 + 1, dtype=np.int64)
            f = 0
            for i in range(1, n1 + 1):
                h = h_prev[i - 1] + int(score_col[s1[i - 1]])
                if h < 0:
                    h = 0
                # f: gap in seq1 direction (horizontal, from h_curr[i-1])
                if h_curr[i - 1] > 0:
                    f = max(f - r, h_curr[i - 1] - qr)
                    if h < f:
                        h = f
                # e: vertical from previous row
                e = max(e_prev[i] - r, h_prev[i] - qr)
                if e < 0:
                    e = 0
                if h < e:
                    h = e
                h_curr[i] = h
                e_curr[i] = e
                if h > best:
                    best = h
                    bi, bj = i, j
            h_prev, e_prev = h_curr, e_curr
        return best, bi, bj

    score_f, end_i, end_j = forward_pass(seq1, seq2)
    if score_f < thres or end_i == 0 or end_j == 0:
        return score_f, [], (0, 0, end_i, end_j)
    # reverse pass on reversed prefixes to find the start
    r1 = seq1[:end_i][::-1]
    r2 = seq2[:end_j][::-1]
    score_r, ri, rj = forward_pass(r1, r2)
    start_i = end_i - ri + 1
    start_j = end_j - rj + 1
    # path via banded global on the matched region (stdaln.c:731-737)
    sub1 = seq1[start_i - 1:end_i]
    sub2 = seq2[start_j - 1:end_j]
    _, path = aln_global_core(sub1, sub2)
    # shift path coordinates to the full sequences
    shifted = [(c, i + start_i - 1, j + start_j - 1) for c, i, j in path]
    return score_f, shifted, (start_i, start_j, end_i, end_j)
