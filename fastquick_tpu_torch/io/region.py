"""Genomic interval sets.

Exact replica of the reference's RegionList (src/RegionList.cpp:
ReadRegionList :15, IsOverlapped :48, Collapse :78, Join :120).
Intervals are CLOSED [start, end] in whatever coordinate system the
caller uses (the reference feeds 1-based positions everywhere), with
the C's own quirks preserved:

- storage is a per-chromosome map keyed by start: ``AddRegion``
  overwrites (last end wins, :74), ``ReadRegionList`` keeps the MAX
  end per start (:31-39);
- ``Collapse`` merges when the next interval starts at or before the
  current end (point-touching merges; gap-of-one stays separate) and
  computes Size as sum(end - start + 1) (:78-117);
- the intersection ``Join`` uses strict ``end1 > beg2`` comparisons,
  silently dropping single-point overlaps (:128-167) -- a C quirk kept
  deliberately;
- ``IsOverlapped(chrom, pos)`` is the closed-interval point query
  start <= pos <= end (:48-66).

Round-4 note: this class previously used half-open BED semantics; the
compiled-reference StatCollector differential
(tests/test_ref_stats_differential.py) caught the resulting one-site
loss at every flank region's left edge, so the semantics now mirror
the C exactly.  Callers that genuinely need BED/bcftools half-open
semantics (refbuilder._subset_dbsnp) shift their endpoints instead.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class RegionList:
    # public view: chrom -> sorted [(start, end)] closed intervals
    regions: dict[str, list[tuple[int, int]]] = field(default_factory=dict)
    collapsed: bool = False

    def _set(self, chrom: str, start: int, end: int,
             keep_max: bool) -> None:
        ivs = self.regions.setdefault(chrom, [])
        for i, (s, e) in enumerate(ivs):
            if s == start:  # std::map: one entry per start key
                if not keep_max or e < end:
                    ivs[i] = (start, end)
                return
        ivs.append((start, end))

    def read_region_list(self, path: str, collapse: bool = True
                         ) -> "RegionList":
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith(("#", "track", "browser")):
                    continue
                parts = line.split()
                chrom, start, end = parts[0], int(parts[1]), int(parts[2])
                chrom = chrom.upper()
                if chrom.startswith("CHR"):
                    chrom = chrom[3:]
                self._set(chrom, start, end, keep_max=True)
        if collapse:
            self.collapse()
        return self

    def add(self, chrom: str, start: int, end: int) -> None:
        """AddRegion (:68-76): map overwrite -- last end wins."""
        self._set(chrom, start, end, keep_max=False)
        self.collapsed = False

    def collapse(self) -> None:
        """Collapse (:78-117): union of closed intervals; merges when
        beg2 <= end1 (touching merges, 1-gap stays separate)."""
        for chrom, ivs in self.regions.items():
            ivs.sort()
            merged: list[tuple[int, int]] = []
            for s, e in ivs:
                if merged and s <= merged[-1][1]:
                    if e > merged[-1][1]:
                        merged[-1] = (merged[-1][0], e)
                else:
                    merged.append((s, e))
            self.regions[chrom] = merged
        self.collapsed = True

    def is_overlapped(self, chrom: str, pos: int) -> bool:
        """IsOverlapped (:48-66): closed point query start<=pos<=end."""
        ivs = self.regions.get(chrom)
        if not ivs:
            return False
        import bisect

        i = bisect.bisect_right(ivs, (pos, float("inf")))
        if i > 0:
            s, e = ivs[i - 1]
            if s <= pos <= e:
                return True
        if i < len(ivs):
            s, e = ivs[i]
            if s <= pos <= e:
                return True
        return False

    def overlaps_interval(self, chrom: str, start: int, end: int) -> bool:
        """Does closed [start, end] intersect any interval?"""
        ivs = self.regions.get(chrom)
        if not ivs:
            return False
        import bisect

        i = bisect.bisect_right(ivs, (start, float("inf")))
        for j in (i - 1, i):
            if 0 <= j < len(ivs):
                s, e = ivs[j]
                if s <= end and start <= e:
                    return True
        return False

    def overlap_len(self, chrom: str, start: int, end: int) -> int:
        """Total overlapped positions of closed [start, end]."""
        ivs = self.regions.get(chrom, [])
        total = 0
        for s, e in ivs:
            lo, hi = max(s, start), min(e, end)
            if lo <= hi:
                total += hi - lo + 1
        return total

    def join_inner(self, other: "RegionList") -> "RegionList":
        """Join(b, false) (:128-167): intersection with the reference's
        strict comparisons (single-point overlaps dropped)."""
        self.collapse()
        out = RegionList()
        for chrom, b_ivs in other.regions.items():
            a_ivs = self.regions.get(chrom)
            if not a_ivs:
                continue
            b_sorted = sorted(b_ivs)
            i = j = 0
            while i < len(a_ivs) and j < len(b_sorted):
                beg1, end1 = a_ivs[i]
                beg2, end2 = b_sorted[j]
                if beg1 <= beg2:
                    if end1 > end2:          # [1,4] and [2,3]
                        out.add(chrom, beg2, end2)
                        j += 1
                    elif end1 > beg2:        # [1,3] and [2,4]
                        out.add(chrom, beg2, end1)
                        i += 1
                    else:                    # [1,2] and [3,4]
                        i += 1
                else:
                    if end1 <= end2:         # [2,3] and [1,4]
                        out.add(chrom, beg1, end1)
                        i += 1
                    elif end1 > beg2 and beg1 < end2:  # [2,4] and [1,3]
                        out.add(chrom, beg1, end2)
                        j += 1
                    else:                    # [3,4] and [1,2]
                        j += 1
        out.collapse()
        return out

    def join_outer(self, other: "RegionList") -> "RegionList":
        """Join(b, true): union via AddRegion overwrites + Collapse."""
        out = RegionList()
        for src in (self, other):
            for chrom, ivs in src.regions.items():
                for s, e in ivs:
                    out.add(chrom, s, e)
        out.collapse()
        return out

    def total_size(self) -> int:
        """Size (:55-62 via Collapse): sum(end - start + 1)."""
        if not self.collapsed:
            self.collapse()
        return sum(e - s + 1
                   for ivs in self.regions.values() for s, e in ivs)

    def __len__(self) -> int:
        return sum(len(v) for v in self.regions.values())
