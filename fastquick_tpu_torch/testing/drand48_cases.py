"""Hit-list batches for the drand48 draw's tests and chip check.

``random_batch`` draws hit lists shaped like the search kernel's output
(the generator of tests/test_drand48_device.py): nondecreasing scores,
one to three score classes, widths from 1 to 100,000 (wide repeat
intervals), every fifth read empty.  ``single_batch`` gives every read
one hit row; ``production_batch`` mostly so, as a real sample's reads
are; ``zero_draw_state`` the state from which a given draw of the stream
is 0.  ``boundary_cases`` engineers single
reads whose draws land within a few units of a double rounding boundary:
an acceptance product next to cnt << 48 and an offset product next to a
multiple of 2^48, each with the stream state that produces it.
"""

from __future__ import annotations

import numpy as np

from ..align.core import Aln

A_MAX = 48
_A48 = 0x5DEECE66D
_C48 = 0xB
_M48 = (1 << 48) - 1
_A48_INV = pow(_A48, -1, 1 << 48)


def random_batch(rng: np.random.Generator, n_reads: int):
    """(n_aln (N,), alns (N, 48, 3)) int32 arrays and the same hit lists
    as Aln objects, one list a read."""
    n_aln = np.zeros(n_reads, np.int32)
    alns = np.zeros((n_reads, A_MAX, 3), np.int32)
    py = []
    for r in range(n_reads):
        kind = r % 5
        if kind == 4:
            py.append([])
            continue
        k = int(rng.integers(1, 3 if kind == 3 else 2))  # score classes
        rows = []
        score = int(rng.integers(0, 4)) * 3
        for c in range(k):
            for _ in range(int(rng.integers(1, 4))):
                width = int(rng.integers(1, [2, 40, 100000, 6][kind]))
                kk = int(rng.integers(0, 1 << 20))
                mm = score // 3
                rows.append((mm, 0, 0, int(rng.integers(0, 2)), kk,
                             kk + width - 1, score))
            score += 3
        rows = rows[:A_MAX]
        n_aln[r] = len(rows)
        for i, t in enumerate(rows):
            alns[r, i, 0] = (t[0] | (t[1] << 6) | (t[2] << 12)
                             | (t[3] << 18) | (t[6] << 19))
            alns[r, i, 1] = t[4]
            alns[r, i, 2] = t[5]
        py.append([Aln(*t) for t in rows])
    return n_aln, alns, py


def single_batch(rng: np.random.Generator, n_reads: int):
    """(n_aln (N,), alns (N, 48, 3)) int32: each read one row of width 1
    to 1,000 with a nonzero packed word."""
    n_aln = np.ones(n_reads, np.int32)
    alns = np.zeros((n_reads, A_MAX, 3), np.int32)
    k = rng.integers(0, 1 << 20, n_reads)
    alns[:, 0, 0] = rng.integers(1, 1 << 26, n_reads)
    alns[:, 0, 1] = k
    alns[:, 0, 2] = k + rng.integers(0, 1000, n_reads)
    return n_aln, alns


def production_batch(rng: np.random.Generator, n_reads: int,
                     empty: float = 0.03, multi: float = 0.03):
    """single_batch with a share `empty` of reads unmapped and a share
    `multi` whose best class is 2 to 8 rows of one repeat (consecutive SA
    intervals)."""
    n_aln, alns = single_batch(rng, n_reads)
    u = rng.random(n_reads)
    n_aln[u < empty] = 0
    rep = np.nonzero(u > 1.0 - multi)[0]
    nb = rng.integers(2, 9, len(rep))
    for r, m in zip(rep, nb):
        w = alns[r, 0, 2] - alns[r, 0, 1] + 1
        for i in range(1, m):
            alns[r, i] = alns[r, 0]
            alns[r, i, 1:] += i * w
        n_aln[r] = m
    return n_aln, alns


def zero_draw_state(steps: int) -> np.ndarray:
    """The state (limbs) whose draw number steps + 1 is 0."""
    return _limbs(_back(((0 - _C48) * _A48_INV) & _M48, steps))


def _back(x: int, steps: int) -> int:
    """The LCG state `steps` draws before x."""
    for _ in range(steps):
        x = ((x - _C48) * _A48_INV) & _M48
    return x


def _limbs(x: int) -> np.ndarray:
    return np.array([(x >> (12 * i)) & 0xFFF for i in range(4)], np.int32)


def boundary_cases(rng: np.random.Generator, n: int):
    """Up to 2n single-read cases as (state0 limbs (4,), n_aln (1,), alns
    (1, 48, 3), kind, exact): n offset cases and up to n acceptance cases
    (a draw whose w0 falls outside 0 < w0 < W is skipped).

    Acceptance: a best class of two rows (widths w0, w1, W = w0 + w1 odd);
    the second row's draw x makes x * W = (w0 << 48) + d exactly, for a
    small d of either sign, so the double product may round onto w0 << 48.
    Offset: one row of odd width w; its offset draw x makes w * x = (j <<
    48) - d, d >= 1, so the double product may round up to j << 48.  d
    runs over 1..3 and powers of two around the half gap of the product's
    53-bit rounding.  ``exact`` is the answer of exact integer arithmetic
    (accepted, or the offset), which C's double answer differs from where
    the rounding crosses."""
    out = []
    for c in range(2 * n):
        kk = int(rng.integers(0, 1 << 20))
        rows = np.zeros((1, A_MAX, 3), np.int32)
        e = int(rng.integers(0, 14))
        d = e + 1 if e < 3 else (1 << (e - 1)) + int(rng.integers(-1, 2))
        if c % 2 == 0:  # acceptance of row 1
            W = int(rng.integers(1 << 10, 1 << 17)) | 1
            d = d if c % 4 == 0 else -d
            x3 = (d * pow(W, -1, 1 << 48)) & _M48
            w0 = (W * x3 - d) >> 48
            if not 0 < w0 < W:
                continue
            state = _back(x3, 3)
            exact = x3 * W > (w0 << 48)
            widths = (w0, W - w0)
        else:  # offset of row 0
            w = int(rng.integers(1 << 10, 1 << 20)) | 1
            x2 = (-d * pow(w, -1, 1 << 48)) & _M48
            state = _back(x2, 2)
            exact = (w * x2) >> 48
            widths = (w,)
        k = kk
        for i, w in enumerate(widths):
            rows[0, i] = (0, k, k + w - 1)
            k += w
        out.append((_limbs(state), np.array([len(widths)], np.int32), rows,
                    "accept" if c % 2 == 0 else "offset", exact))
    return out
