"""Read-pair batches for the pairing kernel's chip check.

``random_pairs`` builds the inputs of ops/pe_device.pairing_sweep for P
pairs at an occurrence cap K, shaped like the one-program step's: each end
has one to three hit rows (row 0 the best score, on the pair's forward /
reverse strand; the others either strand), their occurrences in the
order expand_occurrences gives them, row 0's first occurrence at the
pair's own locus and the rest near it or anywhere on a 32 Mbp text, so a
pair has one or several candidate pairings inside the insert-size window
and some have none; the SE state is row 0's first occurrence with a mapQ
of 0, 23, 37 or 60, and a few pairs are not entered (pair_ok false).

``same_sweep`` holds two sweeps' results equal, and ``recorded_sweeps`` /
``check_sweeps`` hold every sweep a one-program run made (in this process:
a mesh rank too) to the plain version on its own inputs.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import numpy as np

A_MAX = 48
TEXT = 32_000_000


def _end(rng, P: int, K: int, locus, strand0: int, read_len):
    """One end's occurrence planes, hit rows and SE state."""
    n_aln = rng.integers(1, 4, P)
    # occurrences: most ends 1 to 3, some up to K
    n_occ = np.where(rng.random(P) < 0.8, rng.integers(1, 4, P),
                     rng.integers(1, K + 1, P))
    n_occ = np.maximum(n_occ, n_aln)
    # row widths >= 1 summing to n_occ (rows past n_aln: width 0)
    step = (n_occ - n_aln) // n_aln + 1
    w = np.zeros((P, 3), np.int64)
    for i in range(2):
        w[:, i] = np.where(i < n_aln - 1, 1 + rng.integers(0, 1 << 30, P)
                           % step, 0)
    w[np.arange(P), n_aln - 1] = n_occ - w.sum(1)
    ends = np.cumsum(w, 1)
    k = rng.integers(0, TEXT, P)[:, None] + ends - w
    strand = np.where(np.arange(3)[None, :] == 0, strand0,
                      rng.integers(0, 2, (P, 3)))
    score = rng.integers(0, 4, P)[:, None] + np.where(
        np.arange(3)[None, :] == 0, 0, rng.integers(0, 3, (P, 3)))
    meta = (score | rng.integers(0, 2, (P, 3)) << 6
            | rng.integers(0, 3, (P, 3)) << 12 | strand << 18 | score << 19)
    used = np.arange(3)[None, :] < n_aln[:, None]
    alns = np.zeros((P, A_MAX, 3), np.int32)
    alns[:, :3, 0] = np.where(used, meta, 0)
    alns[:, :3, 1] = np.where(used, k, 0)
    alns[:, :3, 2] = np.where(used, k + w - 1, 0)
    t = np.arange(K)[None, :]
    valid = t < n_occ[:, None]
    row = (t >= ends[:, :1]).astype(np.int32) + (t >= ends[:, 1:2])
    near = locus[:, None] + rng.integers(-600, 600, (P, K))
    pos = np.where(rng.random((P, K)) < 0.6, near,
                   rng.integers(0, TEXT, (P, K)))
    pos[:, 0] = locus
    meta0 = alns[:, 0, 0]
    mapq = rng.choice([0, 23, 37, 60], P)
    se = dict(pos=locus, strand=(meta0 >> 18) & 1, mapq=mapq, seq_q=mapq,
              n_mm=meta0 & 63, n_gapo=(meta0 >> 6) & 63,
              n_gape=(meta0 >> 12) & 63, len=read_len)
    occ = dict(pos=np.where(valid, pos, 0).astype(np.int32),
               row=np.where(valid, row, 0).astype(np.int32), valid=valid,
               n_occ=n_occ.astype(np.int32))
    return occ, alns, {k_: np.asarray(v, np.int32) for k_, v in se.items()}


def random_pairs(rng: np.random.Generator, P: int, K: int):
    """(occ0, occ1, alns0, alns1, se0, se1, pair_ok, ii) as numpy arrays:
    the arguments of pairing_sweep before s_mm, max_isize and g_log_n.
    ii is an insert-size estimate of avg 300, std 40 with its high bound
    set (high_b 700)."""
    start = rng.integers(1000, TEXT - 2000, P)
    insert = np.clip(rng.normal(300, 40, P).astype(np.int64), 160, 900)
    read_len = rng.choice([100, 150], P)
    occ0, alns0, se0 = _end(rng, P, K, start, 0, read_len)
    occ1, alns1, se1 = _end(rng, P, K, start + insert - read_len, 1,
                            read_len)
    pair_ok = rng.random(P) < 0.95
    ii = np.array([1.0, 300.0, 40.0, 150.0, 500.0, 700.0, 1e-5], np.float32)
    return occ0, occ1, alns0, alns1, se0, se1, pair_ok, ii


def same_sweep(got, want, what: str) -> None:
    """Raise unless two pairing sweeps agree in every output field of both
    ends and in cnt_chg."""
    import torch

    for j in (0, 1):
        for k, w in want[j].items():
            if not torch.equal(got[j][k], w):
                bad = (got[j][k] != w).nonzero()[:5].flatten().tolist()
                raise AssertionError(f"{what}: end {j} {k}, pairs {bad}")
    if int(got[2]) != int(want[2]):
        raise AssertionError(f"{what}: cnt_chg {int(got[2])} != "
                             f"{int(want[2])}")


@contextlib.contextmanager
def recorded_sweeps(calls: list):
    """Record each pairing sweep qc_step_full runs inside the block, its
    arguments and result, into calls."""
    from ..ops import qc_full

    sweep = qc_full.pairing_sweep

    def record(*args):
        out = sweep(*args)
        calls.append((args, out))
        return out

    with mock.patch.object(qc_full, "pairing_sweep", record):
        yield


def check_sweeps(calls: list, what: str) -> list:
    """Each recorded sweep against pairing_sweep_plain on its own inputs
    (raises unless equal); returns (pairs, k_occ, cnt_chg) of each."""
    from ..ops.pe_device import pairing_sweep_plain

    out = []
    for i, (args, got) in enumerate(calls):
        same_sweep(got, pairing_sweep_plain(*args),
                   f"{what}, pairing sweep {i} != plain")
        out.append((*args[0]["pos"].shape, int(got[2])))
    return out
