"""What the port's ``index`` derives, worked out again from the genome and
the marker VCFs alone: each marker's flank (its contig of the reduced
reference and that contig's offset in the packed text), the dense sites
the statistics count, and the dbSNP positions among them.

FASTQuick's rules, restated: markers are taken in VCF order, the first
``var_long`` with the long flank; a contig is the genome's [pos - f,
pos + f]; the dense sites are each flank less round(0.65 x 151) bp at
either end (StatCollector's FLANK_EDGE and its default read length).
"""

from __future__ import annotations

import math

import numpy as np

FLANK_EDGE = 0.65
OPT_READ_LEN = 151
CHOP = int(math.floor(OPT_READ_LEN * FLANK_EDGE + 0.5))


class Sites:
    def __init__(self, g: dict, index_cfg: dict):
        n = len(g["pos"])
        self.pos = g["pos"]
        self.flank = np.where(np.arange(n) < index_cfg["var_long"],
                              index_cfg["flank_long_len"],
                              index_cfg["flank_len"]).astype(np.int64)
        self.lo = self.pos - self.flank          # 1-based, closed
        self.hi = self.pos + self.flank
        clen = 2 * self.flank + 1
        self.offset = np.concatenate([[0], np.cumsum(clen)[:-1]])
        self.glen = len(g["codes"])
        self.codes = g["codes"]
        # site index of each genome position (1-based), -1 off the sites
        self.site_of = np.full(self.glen + 2, -1, np.int64)
        s_lo, s_hi = self.lo + CHOP, self.hi - CHOP
        lens = s_hi - s_lo + 1
        run = np.repeat(s_lo - np.concatenate([[0], np.cumsum(lens)[:-1]]),
                        lens) + np.arange(int(lens.sum()))
        self.site_of[run] = np.arange(len(run))
        self.n_sites = len(run)
        self.dbsnp = np.zeros(self.glen + 2, bool)
        self.dbsnp[g["pos"][g["dbsnp"]]] = True
        self.marker_at = np.full(self.glen + 2, -1, np.int64)
        self.marker_at[g["pos"]] = np.arange(n)

    def contig_of_text(self, tpos: np.ndarray) -> np.ndarray:
        """The contig of 0-based packed-text positions."""
        return np.searchsorted(self.offset, tpos, side="right") - 1

    def genome_pos(self, tpos: np.ndarray, cid: np.ndarray) -> np.ndarray:
        """1-based genome position of packed-text position tpos in contig
        cid."""
        return self.lo[cid] + (tpos - self.offset[cid])
