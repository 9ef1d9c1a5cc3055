"""The collector every path of the port builds from an index.

``stats/collector.py`` is a copy of the reference package's module.
``KeyedStatCollector`` is its StatCollector with the flank and target
regions held in ``io.region_map.RegionMap``, so ``restore_vcf_sites``
adds one flank a marker in O(1) where the copy's RegionList scans the
chromosome's list (quadratic in the markers on one chromosome).  The
regions, sites and outputs are the same.
"""

from __future__ import annotations

from ..io.region_map import RegionMap
from .collector import StatCollector


class KeyedStatCollector(StatCollector):
    def __init__(self):
        super().__init__()
        self.target_region = RegionMap()
        self.flank_region = RegionMap()
