"""Edge batches for the width kernel: unit lengths around its tile of 32
positions (and the seed launches' 32), a unit count that is not a multiple
of its block of 128 units, all-N units, random codes that restart a bucket
often, units that follow the text (the interval narrows from the whole
index, its ends first in different Occ blocks and then in the same one)
and units whose interval holds the index's primary row, where the row
bounds on either side of it are counted differently."""

from __future__ import annotations

import numpy as np

EDGE_M = 300
EDGE_LENS = (1, 31, 32, 33, 160)


def width_edge_batch(text: np.ndarray, L: int, seed: int = 0):
    """(units (EDGE_M, L) uint8 codes 0..4, sel (EDGE_M,) int32) for the
    forward (sel 0) and reverse (sel 1) FM indexes of `text`; units
    alternate between the two."""
    rng = np.random.default_rng(seed)
    n = len(text)
    units = np.full((EDGE_M, L), 4, np.uint8)
    sel = (np.arange(EDGE_M) % 2).astype(np.int32)
    for m in range(EDGE_M):
        kind = (m // 2) % 5
        if kind == 0:  # all N
            continue
        if kind == 1:  # random codes with Ns: a new bucket every few steps
            units[m] = rng.integers(0, 5, L)
            continue
        if kind == 4:  # the first q codes spell a prefix of the index's text
            q = 1 + int(rng.integers(0, L))
            codes = rng.integers(0, 4, L).astype(np.uint8)
            # step q - 1 searches reverse(codes[:q]): text[:q] in the
            # forward index, the reverse text's prefix in the reverse one
            codes[:q] = text[:q][::-1] if sel[m] == 0 else text[n - q:]
            units[m] = codes
            continue
        s = int(rng.integers(0, n - L))
        sub = text[s:s + L]
        # backward search of codes[i], ..., codes[0] at step i: a substring
        # of the text for sel 0 when the codes run backwards over it
        codes = (sub[::-1] if sel[m] == 0 else sub).copy()
        if kind == 3:  # a mismatch or an N here and there
            for _ in range(int(rng.integers(1, 4))):
                codes[int(rng.integers(0, L))] = int(rng.integers(0, 5))
        units[m] = codes
    return units, sel
