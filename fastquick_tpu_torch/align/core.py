"""Exact-semantics FM-index read alignment (host reference engine).

This module is the behavioral ground truth for the batched TPU engine: a
faithful re-implementation of the reference's seed aligner --
bwt_cal_width (libbwa/bwtaln.c:73-97), the best-first inexact search
bwt_match_gap (libbwa/bwtgap.c:104-264) with its score-bucketed LIFO
stacks, gap_shadow (bwtgap.c:81-91), bwt_match_exact_alt (libbwa/bwt.c),
bwa_aln2seq_core reservoir sampling (libbwa/bwase.c:19-97) and
bwa_approx_mapQ (bwase.c:102-111) -- operating on our FMIndex layout.

Interval convention bridge: BWA uses closed row intervals [k, l] over the
n+1 BWT rows with occ(c, k) counting rows [0..k]; our FMIndex uses
half-open [lo, hi) with occ_at(c, k) counting rows [0, k).  They relate by
occ_bwa(c, k) == occ_at(c, k+1) and L2_bwa[c] == C[c] - 1.

Known modeled quirk: gap_push only assigns last_diff_pos when is_diff is
set (bwtgap.c:60), so no-diff pushes inherit the value left in the stack
slot by its previous occupant.  We model slot persistence (fresh slots
start at 0, matching the initial calloc); C's realloc beyond 4 slots leaves
garbage which we model as 0 -- the only possible divergence, and it only
shifts gap_shadow bookkeeping for multi-hit reads.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..index.fmindex import FMIndex
from .opts import (
    BWA_MODE_GAPE,
    BWA_MODE_LOGGAP,
    BWA_MODE_NONSTOP,
    BWA_TYPE_NO_MATCH,
    BWA_TYPE_REPEAT,
    BWA_TYPE_UNIQUE,
    G_LOG_N,
    GapOpt,
    bwa_cal_maxdiff,
)
from .rand import Rand48

STATE_M, STATE_I, STATE_D = 0, 1, 2


# ---- BWA-style occ bridge ----

def occ_bwa(fm: FMIndex, c: int, k: int) -> int:
    """#occurrences of c in BWT rows [0..k] (closed); k in [-1, n]."""
    if k < 0:
        return 0
    return fm.occ_at(c, k + 1)


def occ4_bwa(fm: FMIndex, k: int) -> tuple[int, int, int, int]:
    return tuple(occ_bwa(fm, c, k) for c in range(4))


def l2(fm: FMIndex, c: int) -> int:
    """BWA L2[c] = #chars strictly smaller than c in the text."""
    return int(fm.C[c]) - 1


def bwt_match_exact_alt(fm: FMIndex, length: int, s: np.ndarray,
                        k: int, l: int) -> tuple[bool, int, int]:
    """Extend [k,l] backward over s[length-1 .. 0] (libbwa/bwt.c
    bwt_match_exact_alt).  Returns (hit, k, l)."""
    for i in range(length - 1, -1, -1):
        c = int(s[i])
        if c > 3:
            return False, k, l
        k = l2(fm, c) + occ_bwa(fm, c, k - 1) + 1
        l = l2(fm, c) + occ_bwa(fm, c, l)
        if k > l:
            return False, k, l
    return True, k, l


def bwt_cal_width(fm: FMIndex, length: int, s: np.ndarray,
                  width: np.ndarray) -> int:
    """Exact-match lower bounds (libbwa/bwtaln.c:73-97).
    width is an (length+1, 2) int array of [w, bid]."""
    k, l = 0, fm.n
    bid = 0
    for i in range(length):
        c = int(s[i])
        if c < 4:
            k = l2(fm, c) + occ_bwa(fm, c, k - 1) + 1
            l = l2(fm, c) + occ_bwa(fm, c, l)
        if k > l or c > 3:
            k = 0
            l = fm.n
            bid += 1
        width[i, 0] = l - k + 1
        width[i, 1] = bid
    width[length, 0] = 0
    bid += 1
    width[length, 1] = bid
    return bid


@dataclass
class Aln:
    """bwt_aln1_t: one SA-interval hit."""

    n_mm: int
    n_gapo: int
    n_gape: int
    a: int  # strand
    k: int
    l: int
    score: int


class _Entry:
    __slots__ = ("info", "k", "l", "n_mm", "n_gapo", "n_gape", "state",
                 "last_diff_pos")

    def __init__(self):
        self.info = 0
        self.k = 0
        self.l = 0
        self.n_mm = 0
        self.n_gapo = 0
        self.n_gape = 0
        self.state = 0
        self.last_diff_pos = 0


class GapStack:
    """Score-bucketed LIFO stacks with slot persistence (gap_init_stack /
    gap_push / gap_pop, bwtgap.c:13-79)."""

    def __init__(self, max_mm: int, max_gapo: int, max_gape: int, opt: GapOpt):
        self.n_stacks = opt.aln_score(max_mm + 1, max_gapo + 1, max_gape + 1)
        self.slots: list[list[_Entry]] = [[] for _ in range(self.n_stacks)]
        self.counts = [0] * self.n_stacks
        self.best = self.n_stacks
        self.n_entries = 0
        self.opt = opt

    def reset(self):
        for i in range(self.n_stacks):
            self.counts[i] = 0
        self.best = self.n_stacks
        self.n_entries = 0

    def push(self, a: int, i: int, k: int, l: int, n_mm: int, n_gapo: int,
             n_gape: int, state: int, is_diff: bool):
        score = self.opt.aln_score(n_mm, n_gapo, n_gape)
        bucket = self.slots[score]
        n = self.counts[score]
        if n == len(bucket):
            bucket.append(_Entry())  # fresh slot, last_diff_pos = 0
        e = bucket[n]
        e.info = (score << 21) | (a << 20) | i
        e.k = k
        e.l = l
        e.n_mm = n_mm
        e.n_gapo = n_gapo
        e.n_gape = n_gape
        e.state = state
        if is_diff:
            e.last_diff_pos = i
        # else: slot-persistent stale value (see module docstring)
        self.counts[score] = n + 1
        self.n_entries += 1
        if self.best > score:
            self.best = score

    def pop(self) -> _Entry:
        score = self.best
        n = self.counts[score] - 1
        e = self.slots[score][n]
        self.counts[score] = n
        self.n_entries -= 1
        if n == 0 and self.n_entries:
            i = score + 1
            while i < self.n_stacks and self.counts[i] == 0:
                i += 1
            self.best = i
        elif self.n_entries == 0:
            self.best = self.n_stacks
        return e


def gap_shadow(x: int, length: int, mx: int, last_diff_pos: int,
               width: np.ndarray) -> None:
    """bwtgap.c:81-91: deflate width lower bounds after a hit."""
    j = 0
    for i in range(last_diff_pos):
        if width[i, 0] > x:
            width[i, 0] -= x
        elif width[i, 0] == x:
            width[i, 1] = 1
            j += 1
            width[i, 0] = mx - j


def _int_log2(v: int) -> int:
    c = 0
    if v & 0xFFFF0000:
        v >>= 16
        c |= 16
    if v & 0xFF00:
        v >>= 8
        c |= 8
    if v & 0xF0:
        v >>= 4
        c |= 4
    if v & 0xC:
        v >>= 2
        c |= 2
    if v & 0x2:
        c |= 1
    return c


def bwt_match_gap(fms: tuple[FMIndex, FMIndex], length: int,
                  seqs: tuple[np.ndarray, np.ndarray],
                  w: tuple[np.ndarray, np.ndarray],
                  seed_w: tuple[np.ndarray, np.ndarray] | None,
                  opt: GapOpt, stack: GapStack) -> list[Aln]:
    """Faithful bwt_match_gap (bwtgap.c:104-264).

    fms[0]/fms[1] are the forward/reverse FM-indexes (bwt_d / rbwt_d);
    strand a searches seqs[a] on fms[1-a].  seqs[0] is the reversed read,
    seqs[1] the reverse-complement.  w are mutable (len+1, 2) width arrays.
    """
    best_score = opt.aln_score(opt.max_diff + 1, opt.max_gapo + 1,
                               opt.max_gape + 1)
    best_diff = opt.max_diff + 1
    max_diff = opt.max_diff
    best_cnt = 0
    aln: list[Aln] = []

    n_n = int(np.count_nonzero(seqs[0][:length] > 3))
    if n_n > max_diff:
        return aln

    stack.reset()
    seq_len = fms[0].n
    stack.push(0, length, 0, seq_len, 0, 0, 0, 0, False)
    stack.push(1, length, 0, seq_len, 0, 0, 0, 0, False)

    while stack.n_entries:
        if stack.n_entries > opt.max_entries:
            break
        e = stack.pop()
        k, l = e.k, e.l
        a = (e.info >> 20) & 1
        i = e.info & 0xFFFF
        e_score = e.info >> 21
        e_n_mm, e_n_gapo, e_n_gape = e.n_mm, e.n_gapo, e.n_gape
        e_state, e_last_diff_pos = e.state, e.last_diff_pos
        if not (opt.mode & BWA_MODE_NONSTOP) and e_score > best_score + opt.s_mm:
            break

        m = max_diff - (e_n_mm + e_n_gapo)
        if opt.mode & BWA_MODE_GAPE:
            m -= e_n_gape
        if m < 0:
            continue
        fm = fms[1 - a]
        s = seqs[a]
        width = w[a]
        m_seed = 0
        seed_width = None
        if seed_w is not None:
            seed_width = seed_w[a]
            m_seed = opt.max_seed_diff - (e_n_mm + e_n_gapo)
            if opt.mode & BWA_MODE_GAPE:
                m_seed -= e_n_gape
        if i > 0 and m < width[i - 1, 1]:
            continue

        # hit check
        hit_found = False
        if i == 0:
            hit_found = True
        elif m == 0 and (e_state == STATE_M or (opt.mode & BWA_MODE_GAPE)
                         or e_n_gape == opt.max_gape):
            ok, k, l = bwt_match_exact_alt(fm, i, s, k, l)
            if ok:
                hit_found = True
            else:
                continue

        if hit_found:
            score = opt.aln_score(e_n_mm, e_n_gapo, e_n_gape)
            do_add = True
            if not aln:
                best_score = score
                best_diff = e_n_mm + e_n_gapo
                if opt.mode & BWA_MODE_GAPE:
                    best_diff += e_n_gape
                if not (opt.mode & BWA_MODE_NONSTOP):
                    max_diff = (opt.max_diff if best_diff + 1 > opt.max_diff
                                else best_diff + 1)
            if score == best_score:
                best_cnt += l - k + 1
            elif best_cnt > opt.max_top2:
                break
            if e_n_gapo:
                for q in aln:
                    if q.k == k and q.l == l:
                        do_add = False
                        break
            if do_add:
                gap_shadow(l - k + 1, length, fm.n, e_last_diff_pos, width)
                aln.append(Aln(e_n_mm, e_n_gapo, e_n_gape, a, k, l, score))
            continue

        i -= 1
        cnt_k = occ4_bwa(fm, k - 1)
        cnt_l = occ4_bwa(fm, l)
        occ = l - k + 1

        allow_diff = allow_m = True
        if i > 0:
            ii = i - (length - opt.seed_len)
            if width[i - 1, 1] > m - 1:
                allow_diff = False
            elif (width[i - 1, 1] == m - 1 and width[i, 1] == m - 1
                  and width[i - 1, 0] == width[i, 0]):
                allow_m = False
            if seed_width is not None and ii > 0:
                if seed_width[ii - 1, 1] > m_seed - 1:
                    allow_diff = False
                elif (seed_width[ii - 1, 1] == m_seed - 1
                      and seed_width[ii, 1] == m_seed - 1
                      and seed_width[ii - 1, 0] == seed_width[ii, 0]):
                    allow_m = False

        # indels
        if opt.mode & BWA_MODE_LOGGAP:
            tmp = _int_log2(e_n_gape + e_n_gapo) // 2 + 1
        else:
            tmp = e_n_gapo + e_n_gape
        if (allow_diff and i >= opt.indel_end_skip + tmp
                and length - i >= opt.indel_end_skip + tmp):
            if e_state == STATE_M:
                if e_n_gapo < opt.max_gapo:
                    # insertion
                    stack.push(a, i, k, l, e_n_mm, e_n_gapo + 1, e_n_gape,
                               STATE_I, True)
                    # deletion
                    for j in range(4):
                        kj = l2(fm, j) + cnt_k[j] + 1
                        lj = l2(fm, j) + cnt_l[j]
                        if kj <= lj:
                            stack.push(a, i + 1, kj, lj, e_n_mm, e_n_gapo + 1,
                                       e_n_gape, STATE_D, True)
            elif e_state == STATE_I:
                if e_n_gape < opt.max_gape:
                    stack.push(a, i, k, l, e_n_mm, e_n_gapo, e_n_gape + 1,
                               STATE_I, True)
            elif e_state == STATE_D:
                if e_n_gape < opt.max_gape:
                    if e_n_gape + e_n_gapo < max_diff or occ < opt.max_del_occ:
                        for j in range(4):
                            kj = l2(fm, j) + cnt_k[j] + 1
                            lj = l2(fm, j) + cnt_l[j]
                            if kj <= lj:
                                stack.push(a, i + 1, kj, lj, e_n_mm, e_n_gapo,
                                           e_n_gape + 1, STATE_D, True)
        # mismatches
        if allow_diff and allow_m:
            for j in range(1, 5):
                c = (int(s[i]) + j) & 3
                is_mm = (j != 4 or int(s[i]) > 3)
                kj = l2(fm, c) + cnt_k[c] + 1
                lj = l2(fm, c) + cnt_l[c]
                if kj <= lj:
                    stack.push(a, i, kj, lj, e_n_mm + (1 if is_mm else 0),
                               e_n_gapo, e_n_gape, STATE_M, is_mm)
        elif int(s[i]) < 4:
            c = int(s[i]) & 3
            kj = l2(fm, c) + cnt_k[c] + 1
            lj = l2(fm, c) + cnt_l[c]
            if kj <= lj:
                stack.push(a, i, kj, lj, e_n_mm, e_n_gapo, e_n_gape,
                           STATE_M, False)

    return aln


# ---- bwa_aln2seq / mapQ ----

@dataclass
class Multi:
    """bwt_multi1_t."""

    pos: int  # SA row first, later real position
    strand: int
    gap: int
    mm: int
    cigar: list[tuple[int, int]] | None = None


def bwa_aln2seq_core(aln: list[Aln], s, set_main: bool, n_multi: int,
                     rng: Rand48) -> None:
    """libbwa/bwase.c:19-97 including drand48 reservoir sampling."""
    if not aln:
        s.type = BWA_TYPE_NO_MATCH
        s.c1 = s.c2 = 0
        return
    if set_main:
        best = aln[0].score
        cnt = 0
        idx = len(aln)
        for i, p in enumerate(aln):
            if p.score > best:
                idx = i
                break
            if rng.drand48() * (p.l - p.k + 1 + cnt) > cnt:
                s.n_mm = p.n_mm
                s.n_gapo = p.n_gapo
                s.n_gape = p.n_gape
                s.strand = p.a
                s.score = p.score
                s.sa = p.k + int((p.l - p.k + 1) * rng.drand48())
            cnt += p.l - p.k + 1
        s.c1 = cnt
        for p in aln[idx:]:
            cnt += p.l - p.k + 1
        s.c2 = cnt - s.c1
        s.type = BWA_TYPE_REPEAT if s.c1 > 1 else BWA_TYPE_UNIQUE

    if n_multi:
        n_occ = sum(q.l - q.k + 1 for q in aln)
        if n_occ > n_multi + 1:
            s.multi = []
            s.n_multi = 0
            return
        rest = n_occ
        multi: list[Multi] = []
        for q in aln:
            if q.l - q.k + 1 <= rest:
                for row in range(q.k, q.l + 1):
                    multi.append(Multi(pos=row, strand=q.a,
                                       gap=q.n_gapo + q.n_gape, mm=q.n_mm))
                rest -= q.l - q.k + 1
            else:  # random sampling; "we never come here" (bwase.c:76)
                j = rest
                i = q.l - q.k + 1
                while j > 0:
                    p = 1.0
                    x = rng.drand48()
                    while x < p:
                        p -= p * j / i
                        i -= 1
                    multi.append(Multi(pos=q.l - i, strand=q.a,
                                       gap=q.n_gapo + q.n_gape, mm=q.n_mm))
                    j -= 1
                break
        multi = [m for m in multi if m.pos != s.sa]
        s.multi = multi[: n_multi] if len(multi) >= n_multi else multi
        s.n_multi = len(s.multi)


def bwa_approx_mapQ(p, mm: int) -> int:
    """bwase.c:102-111."""
    if p.c1 == 0:
        return 23
    if p.c1 > 1:
        return 0
    if p.n_mm == mm:
        return 25
    if p.c2 == 0:
        return 37
    n = 255 if p.c2 >= 255 else p.c2
    g = G_LOG_N[n]
    return 0 if 23 < g else 23 - g
