"""Dense site-coordinate table for vectorized statistics accumulation.

The reference accumulates per-base statistics through hash maps keyed on
(chrom, position) (StatCollector.h PositionTable + Depth/Q20/Q30 vectors)
with a per-base loop.  Here the trimmed flank regions are laid out as one
compact dense coordinate space (a few MB for the 10k-marker panel), so a
read's M-segment updates become numpy slice scatter-adds -- and map 1:1
onto the device accumulators in ops/pileup.py.
"""

from __future__ import annotations

import numpy as np


class DenseSites:
    """Compact index over the collapsed flank regions of one run."""

    def __init__(self, regions: dict[str, list[tuple[int, int]]]):
        # regions: chrom -> sorted collapsed [start, end) 0-based intervals
        self.chroms: dict[str, dict] = {}
        total = 0
        for chrom in regions:
            ivs = regions[chrom]
            starts = np.array([s for s, _ in ivs], dtype=np.int64)
            ends = np.array([e for _, e in ivs], dtype=np.int64)
            offs = np.zeros(len(ivs), dtype=np.int64)
            offs[0:] = total + np.concatenate(
                [[0], np.cumsum(ends - starts)[:-1]])
            total += int((ends - starts).sum())
            self.chroms[chrom] = {"starts": starts, "ends": ends,
                                  "offsets": offs}
        # (starts, ends, offsets) tuples for the hot query path
        self._fast = {ch: (d["starts"], d["ends"], d["offsets"])
                      for ch, d in self.chroms.items()}
        self.total = total
        self.depth = np.zeros(total, dtype=np.int64)
        self.q20 = np.zeros(total, dtype=np.int64)
        self.q30 = np.zeros(total, dtype=np.int64)
        self.gc = np.zeros(total, dtype=np.int16)  # per-position GC content
        self.dbsnp = np.zeros(total, dtype=bool)

    def index_range(self, chrom: str, start: int, end: int):
        """Map 1-based positions [start, end) to (positions, dense_idx)
        restricted to in-region sites.  Returns int64 arrays."""
        c = self._fast.get(chrom)
        if c is None or end <= start:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64))
        starts, ends, offsets = c
        s0 = start - 1
        # fast path: the whole range inside one region (the common case
        # for a read segment against a marker flank) needs no per-position
        # searchsorted/masking
        iv1 = int(starts.searchsorted(s0, side="right")) - 1
        if iv1 >= 0 and end - 1 <= ends[iv1]:
            base = int(offsets[iv1]) - int(starts[iv1])
            p0 = np.arange(s0, end - 1, dtype=np.int64)
            return (p0 + 1, p0 + base)
        p0 = np.arange(start - 1, end - 1, dtype=np.int64)  # 0-based
        iv = starts.searchsorted(p0, side="right") - 1
        ok = iv >= 0
        iv_c = np.clip(iv, 0, len(starts) - 1)
        ok &= p0 < ends[iv_c]
        idx = offsets[iv_c] + (p0 - starts[iv_c])
        return (p0[ok] + 1, idx[ok])  # back to 1-based positions

    def fill_from_position_map(self, chrom: str, values: dict[int, int],
                               field: str) -> None:
        """Populate a per-position field (gc / dbsnp) from a dict of
        1-based positions."""
        if not values:
            return
        self.fill_from_positions(
            chrom, np.fromiter(values.keys(), dtype=np.int64),
            np.fromiter(values.values(), dtype=np.int64), field)

    def fill_from_positions(self, chrom: str, pos: np.ndarray,
                            val: np.ndarray | None, field: str) -> None:
        """Populate a per-position field (gc / dbsnp) from 1-based
        position + value arrays (duplicate positions: last wins, like
        the dict-based path)."""
        c = self.chroms.get(chrom)
        if c is None or len(pos) == 0:
            return
        p0 = pos - 1
        iv = np.searchsorted(c["starts"], p0, side="right") - 1
        ok = iv >= 0
        iv_c = np.clip(iv, 0, len(c["starts"]) - 1)
        ok &= p0 < c["ends"][iv_c]
        idx = (c["offsets"][iv_c] + (p0 - c["starts"][iv_c]))[ok]
        getattr(self, field)[idx] = val[ok] if field == "gc" else True
