"""The least time the card could take for the one-program step's
accumulation, from the batch's own shapes: a frozen copy of the port's
``utils/bounds.walk_bound`` (PR 12), so that the yardstick stays the same
whatever implements the work.

The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM
bytes/s and fp32 operations/s outside the tensor cores, a bound for the
kernels' 32-bit integer work.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
# integer operations of one covered base: its pac position and clamps,
# the region and mismatch tests, the tier and the bins, the index
# arithmetic
OPS_ACC_BASE = 20


def bound(bytes_: float, ops: float) -> tuple[float, str]:
    """(seconds, "bytes" | "operations")."""
    tb, to = bytes_ / HBM_BYTES_S, ops / FP32_OPS_S
    return (tb, "bytes") if tb >= to else (to, "operations")


def walk_bound(B: int, n_cover: int, n_reg: int, n_entry_reads: int,
               S: int, M: int, cap: int, elem: int = 4,
               per_read: int = 25) -> tuple[float, str]:
    """The accumulation of B reads: each covered base's site word; each of
    the n_reg bases in a region's code and quality (elem bytes each),
    text word, dbSNP flag and marker word; per_read bytes a read
    (position, strand, length, eligible); mapq of the n_entry_reads reads
    with a pileup entry; the dense output (depth, q20, q30, four 256-bin
    histograms, the mapped-base count) and the pileup output (M x cap
    entries, M counts, the overflow), each written once."""
    bytes_ = (4 * n_cover + n_reg * (2 * elem + 5 + 4) + B * per_read
              + 8 * n_entry_reads + 4 * (3 * S + 4 * 256 + 1)
              + 4 * (M * cap + M + 1))
    return bound(bytes_, n_cover * OPS_ACC_BASE)
