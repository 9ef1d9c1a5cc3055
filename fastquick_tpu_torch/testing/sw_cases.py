"""Edge batches for the Smith-Waterman forward kernel: the query lengths
around the wavefront's strip of 32 rows, empty and one-base refs, all-N
sequences, and jobs whose best score is reached in several cells, so the
first-maximum rule (earliest query row, then earliest ref column) decides
the end cell."""

from __future__ import annotations

import numpy as np

EDGE_RL, EDGE_QL = 640, 160


def sw_edge_batch(seed: int = 0):
    """(refs (B, 640), queries (B, 160), rlens, qlens) as uint8 / int32
    numpy arrays, padding with code 0."""
    rng = np.random.default_rng(seed)
    jobs = []

    def rand(n):
        return rng.integers(0, 4, n).astype(np.uint8)

    for ql in (1, 31, 32, 33, 150):
        for rl in (0, 1, EDGE_RL):
            ref = rand(rl)
            q = rand(ql)
            if rl >= ql:  # plant the query with a mismatch or two
                s = int(rng.integers(0, rl - ql + 1))
                q = ref[s:s + ql].copy()
                for _ in range(int(rng.integers(0, 3))):
                    p = int(rng.integers(0, ql))
                    q[p] = (q[p] + 1) % 4
            jobs.append((ref, q))
    jobs.append((rand(EDGE_RL), np.full(150, 4, np.uint8)))  # all-N query
    jobs.append((np.full(EDGE_RL, 4, np.uint8), rand(150)))  # all-N ref

    def flanked(*parts):
        """parts separated and surrounded by N runs, so no match extends
        past a planted copy"""
        gap = np.full(40, 4, np.uint8)
        out = [gap]
        for p in parts:
            out += [p, gap]
        return np.concatenate(out)

    for n in (20, 32):
        x = rand(n)
        jobs.append((flanked(x), np.concatenate([x, x])))  # tie across rows
        jobs.append((flanked(x, x), x))  # tie across columns of one row
        jobs.append((flanked(x, x), np.concatenate([x, x, x])))  # both
    x = rand(32)  # the same lane's row in four strips
    jobs.append((flanked(x), np.concatenate([x] * 4)))
    B = len(jobs)
    refs = np.zeros((B, EDGE_RL), np.uint8)
    qs = np.zeros((B, EDGE_QL), np.uint8)
    rl = np.zeros(B, np.int32)
    ql = np.zeros(B, np.int32)
    for b, (r, q) in enumerate(jobs):
        refs[b, :len(r)] = r
        qs[b, :len(q)] = q
        rl[b], ql[b] = len(r), len(q)
    return refs, qs, rl, ql
