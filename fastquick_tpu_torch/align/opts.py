"""Alignment options.

Equivalents of gap_opt_t (reference libbwa/bwtaln.c:24-50 gap_init_opt) and
pe_opt_t (libbwa/bwape.c:7-20 bwa_init_pe_opt), same defaults.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

BWA_AVG_ERR = 0.02
BWA_MIN_RDLEN = 35

# mode bits (libbwa/bwtaln.h)
BWA_MODE_GAPE = 0x01
BWA_MODE_COMPREAD = 0x02
BWA_MODE_LOGGAP = 0x04
BWA_MODE_NONSTOP = 0x10
BWA_MODE_IL13 = 0x200

# SAM flags
SAM_FPD = 1  # paired
SAM_FPP = 2  # properly paired
SAM_FSU = 4  # self-unmapped
SAM_FMU = 8  # mate-unmapped
SAM_FSR = 16  # self on reverse strand
SAM_FMR = 32  # mate on reverse strand
SAM_FR1 = 64  # this is read one
SAM_FR2 = 128  # this is read two
SAM_FSC = 256  # secondary alignment

# alignment types (bwtaln.h)
BWA_TYPE_NO_MATCH = 0
BWA_TYPE_UNIQUE = 1
BWA_TYPE_REPEAT = 2
BWA_TYPE_MATESW = 3

SW_MIN_MATCH_LEN = 20  # bwape.c
SW_MIN_MAPQ = 17  # bwape.c


@dataclass
class GapOpt:
    s_mm: int = 3
    s_gapo: int = 11
    s_gape: int = 4
    max_diff: int = -1
    max_gapo: int = 1
    max_gape: int = 6
    indel_end_skip: int = 5
    max_del_occ: int = 10
    max_entries: int = 2000000
    mode: int = BWA_MODE_GAPE | BWA_MODE_COMPREAD
    seed_len: int = 32
    max_seed_diff: int = 2
    fnr: float = 0.02
    n_threads: int = 4
    max_top2: int = 30
    trim_qual: int = 0
    flank_len: int = 250
    flank_long_len: int = 1000
    num_variant_long: int = 1000
    num_variant_short: int = 9000
    out_bam: int = 1
    in_bam: int = 0
    cal_dup: int = 1
    frac: float = 1.0
    read_len: int = 151

    def aln_score(self, m: int, o: int, e: int) -> int:
        return m * self.s_mm + o * self.s_gapo + e * self.s_gape


@dataclass
class PeOpt:
    max_isize: int = 500
    force_isize: int = 0
    max_occ: int = 100000
    n_multi: int = 3
    N_multi: int = 10
    type: int = 0  # BWA_PET_STD
    is_sw: int = 1
    ap_prior: float = 1e-5


_maxdiff_cache: dict[tuple[int, float, float], int] = {}


def bwa_cal_maxdiff(l: int, err: float = BWA_AVG_ERR, thres: float = 0.02) -> int:
    """Poisson maxdiff threshold (libbwa/bwtaln.c:58-70)."""
    key = (l, err, thres)
    v = _maxdiff_cache.get(key)
    if v is not None:
        return v
    elambda = math.exp(-l * err)
    y = 1.0
    x = 1
    s = elambda
    out = 2
    for k in range(1, 1000):
        y *= l * err
        x *= k
        s += elambda * y / x
        if 1.0 - s < thres:
            out = k
            break
    _maxdiff_cache[key] = out
    return out


# g_log_n from bwase_initialize: (int)(4.343 * log(n) + 0.5)
G_LOG_N = [0] + [int(4.343 * math.log(n) + 0.5) for n in range(1, 256)]
