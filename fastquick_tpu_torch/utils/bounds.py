"""The least time the card could take for a kernel's work: bytes and
operations.

The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM
bytes/s and fp32 operations/s outside the tensor cores.  The kernels do
32-bit integer work, whose rate on Hopper is at most the fp32 rate, so
time = ops / FP32_OPS_S is a valid lower bound.  chip_smoke.py and the
bench (bench.py, sweep.py) compute their bounds here, so both hold the
same count.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
# integer operations of one search step, counted from the kernels' inner
# loops (csrc/*_body.cuh): at least one pair of single-base rank queries
# (8 words x ~7 ops + ~15 addressing each; a chain step; expansions cost
# ~4x more)
OPS_SEARCH_STEP_MIN = 150
# dependent integer and double operations of one drand48 draw
# (csrc/drand48_body.cuh: the LCG's 64-bit multiply-add and mask, the
# conversion, the double multiply and the compare or truncation)
OPS_DRAW = 10
# operations of one pairing step that pairs a reverse entry with the
# opposite end's two forward slots (csrc/pairing_body.cuh): two 64-bit
# hash_64 mixes (~40 32-bit operations each), the gates, the score word
# and the key compares and updates; forward entries, empty slots and the
# result are not counted, so the bound stays below the work
OPS_PAIR_STEP = 150
# operations of one compare of the entries' sort: a 64-bit compare and
# select on 32-bit units
OPS_PAIR_CMP = 3

def bound(bytes_: float, ops: float) -> tuple[float, str]:
    """(ms, "bytes" | "operations"): the larger of bytes over the HBM rate
    and operations over the fp32 rate."""
    tb, to = bytes_ / HBM_BYTES_S * 1e3, ops / FP32_OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def search_bytes(P, N: int, tab_bytes: int, n_rows: int, outs: int) -> int:
    """The bytes a search of N reads must move: its inputs (codes, four
    scalars, the width rows of both strands and of the seeds, the FM table
    once), `outs` int32 scalars out per read and the n_rows hit rows it
    emitted (12 bytes each)."""
    in_bytes = (N * P.L + 16 * N + 2 * N * (P.L + 1) * 8
                + 2 * N * (P.SL + 1) * 8 + tab_bytes)
    return in_bytes + 4 * outs * N + 12 * n_rows


def search_bound(P, N: int, tab_bytes: int, n_aln, steps: int,
                 outs: int) -> tuple[float, str]:
    """The least time of a search of N reads (search_bytes, with the hit
    rows of the (N,) n_aln tensor) taking `steps` steps."""
    n_rows = int(n_aln.clamp(0, 48).long().sum())
    return bound(search_bytes(P, N, tab_bytes, n_rows, outs),
                 steps * OPS_SEARCH_STEP_MIN)


def pairing_bound(P: int, n_valid: int, n_rev: int, n_words: int,
                  n_cmp: float, pen_len: int) -> tuple[float, str]:
    """The least time of pairing_sweep's kernel on P pairs: each pair's two
    occurrence counts and pair_ok, its n_valid valid entries' position and
    row (8 bytes each; the rest of the (P, K) planes is not read), the
    n_words packed words they name, the SE state in (16 int32 a pair) and
    out (14 int32 and 2 flags), cnt, the penalty table and g_log_n; and
    the operations of n_rev reverse entries' pairing steps and of n_cmp
    compares, the least that sort each pair's entries (log2 n! a pair)."""
    bytes_ = (9 * P + 8 * n_valid + 4 * n_words + 64 * P + 58 * P + 4
              + 4 * pen_len + 4 * 256)
    return bound(bytes_, n_rev * OPS_PAIR_STEP + n_cmp * OPS_PAIR_CMP)


# integer operations of one covered base of the accumulation kernels
# (csrc/accumulate_body.cuh): its pac position and clamps, the region and
# mismatch tests, the tier and the bins, the index arithmetic
OPS_ACC_BASE = 20


def accumulate_bound(B: int, n_cover: int, n_reg: int, S: int,
                     elem: int, per_read: int,
                     output: bool = True) -> tuple[float, str]:
    """The least time of the dense accumulation of B reads: each of the
    n_cover covered bases' site word, each of the n_reg bases in a
    region's code and quality (elem bytes each), text word and dbSNP
    flag, per_read bytes a read (position, strand, length and, in the
    one-program step, the eligible flag), and the output (depth, q20,
    q30, four 256-bin histograms, n_base_mapped: int32) unless output is
    False (a DeviceDenseStats chunk adds into sums that stay on the card:
    the run's one drain moves them); OPS_ACC_BASE operations a covered
    base."""
    bytes_ = (4 * n_cover + n_reg * (2 * elem + 5) + B * per_read
              + (4 * (3 * S + 4 * 256 + 1) if output else 0))
    return bound(bytes_, n_cover * OPS_ACC_BASE)


def walk_bound(B: int, n_cover: int, n_reg: int, n_entry_reads: int,
               S: int, M: int, cap: int, elem: int,
               per_read: int) -> tuple[float, str]:
    """The least time of the one-program step's accumulation of B reads
    in one walk (the dense sums and the marker pileups): accumulate_bound's
    bytes with its output, the marker word of each of the n_reg bases in a
    region, mapq (8 bytes) of the n_entry_reads reads with an entry and
    the pileup output (M x cap entries, M counts, the overflow count:
    int32); OPS_ACC_BASE operations a covered base."""
    bytes_ = (4 * n_cover + n_reg * (2 * elem + 5 + 4) + B * per_read
              + 8 * n_entry_reads + 4 * (3 * S + 4 * 256 + 1)
              + 4 * (M * cap + M + 1))
    return bound(bytes_, n_cover * OPS_ACC_BASE)


def pileup_bound(B: int, n_cover: int, n_on_marker: int, n_entries: int,
                 n_entry_reads: int, M: int, cap: int,
                 elem: int) -> tuple[float, str]:
    """The least time of the marker pileups of B reads without slot
    offsets: each of the n_cover covered bases' marker word, the site word
    of the n_on_marker covered bases at a marker, each of the n_entries
    entries' code and quality (elem bytes each), 17 bytes a read
    (position, length, eligible), strand and mapq (16 bytes) of the
    n_entry_reads reads with an entry, and the output (M x cap entries,
    M counts, the overflow count: int32); OPS_ACC_BASE operations a
    covered base."""
    bytes_ = (4 * n_cover + 4 * n_on_marker + 2 * elem * n_entries + 17 * B
              + 16 * n_entry_reads + 4 * (M * cap + M + 1))
    return bound(bytes_, n_cover * OPS_ACC_BASE)
