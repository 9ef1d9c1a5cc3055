"""RegionList with each chromosome's starts kept in a map.

``io/region.py`` is a copy of the reference package's module. Its
``_set`` keeps std::map's one entry per start (src/RegionList.cpp:68-76)
by scanning the chromosome's whole list for an equal start before it
appends, so n intervals on one chromosome cost n^2/2 compares: the
collector's 10,000 marker flanks (``restore_vcf_sites``) take seconds on
every call that builds a collector.  ``RegionMap`` finds the start in a
dict (start -> slot in the list) instead.  Everything else is
RegionList's own: ``add`` overwrites (last end wins),
``read_region_list`` keeps the larger end, ``regions`` holds the same
lists in the same order, and ``collapse`` and the queries are inherited.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .region import RegionList


@dataclass
class RegionMap(RegionList):
    # chrom -> (the list of `regions` it indexes, start -> slot in that
    # list); rebuilt when `regions` holds another list, as after collapse()
    _slots: dict[str, tuple[list, dict[int, int]]] = field(
        default_factory=dict, repr=False, compare=False)

    def _set(self, chrom: str, start: int, end: int,
             keep_max: bool) -> None:
        ivs = self.regions.setdefault(chrom, [])
        held = self._slots.get(chrom)
        if held is None or held[0] is not ivs:
            held = self._slots[chrom] = (
                ivs, {s: i for i, (s, _) in enumerate(ivs)})
        slots = held[1]
        i = slots.get(start)
        if i is None:
            slots[start] = len(ivs)
            ivs.append((start, end))
        elif not keep_max or ivs[i][1] < end:
            ivs[i] = (start, end)
