"""The least time the card could take for the one-program step's search
and pairing launches, from the counts the step reports: frozen copies of
the port's ``utils/bounds.search_bound`` and ``pairing_bound`` (PRs 7 and
10), so that the yardstick stays the same whatever implements the work.

The peaks and ``bound`` are ``bounds.py``'s (NVIDIA H100 SXM data sheet, at
700 W); the result is in seconds.
"""

from __future__ import annotations

from .bounds import bound

# integer operations of one search step: at least one pair of single-base
# rank queries (8 words x ~7 ops + ~15 addressing each; a chain step)
OPS_SEARCH_STEP_MIN = 150
# operations of one pairing step that pairs a reverse entry with the
# opposite end's two forward slots: two 64-bit hash mixes, the gates, the
# score word and the key compares and updates
OPS_PAIR_STEP = 150
# operations of one compare of the entries' sort
OPS_PAIR_CMP = 3


def search_bound(L: int, SL: int, N: int, tab_bytes: int, n_rows: int,
                 steps: int, outs: int = 4) -> tuple[float, str]:
    """A search of N reads padded to L (seed length SL) taking `steps`
    steps: its inputs (codes, four scalars, the width rows of both strands
    and of the seeds, the FM table once), `outs` int32 scalars out a read
    and the n_rows hit rows it emitted (12 bytes each)."""
    in_bytes = (N * L + 16 * N + 2 * N * (L + 1) * 8
                + 2 * N * (SL + 1) * 8 + tab_bytes)
    return bound(in_bytes + 4 * outs * N + 12 * n_rows,
                 steps * OPS_SEARCH_STEP_MIN)


def pairing_bound(P: int, n_valid: int, n_rev: int, n_words: int,
                  n_cmp: float, pen_len: int) -> tuple[float, str]:
    """One pairing launch on P pairs: each pair's two occurrence counts and
    pair_ok, its n_valid valid entries' position and row (8 bytes each),
    the n_words packed words they name, the SE state in (16 int32 a pair)
    and out (14 int32 and 2 flags), cnt, the penalty table and g_log_n;
    the operations of n_rev reverse entries' pairing steps and of n_cmp
    compares."""
    bytes_ = (9 * P + 8 * n_valid + 4 * n_words + 64 * P + 58 * P + 4
              + 4 * pen_len + 4 * 256)
    return bound(bytes_, n_rev * OPS_PAIR_STEP + n_cmp * OPS_PAIR_CMP)
