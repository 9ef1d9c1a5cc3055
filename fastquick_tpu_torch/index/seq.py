"""Nucleotide encoding utilities.

Mirrors libbwa's nst_nt4_table (A/a=0 C/c=1 G/g=2 T/t=3, everything else 4)
and the deterministic lrand48-based N filling used when packing the reduced
reference (reference src/BwtIndexer.cpp:846-850: bns->seed = 11; srand48;
N -> lrand48() & 3).
"""

from __future__ import annotations

import numpy as np

# nst_nt4_table equivalent: 256-entry lookup
NT4_TABLE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    NT4_TABLE[ord(_c)] = _i
    NT4_TABLE[ord(_c.lower())] = _i

COMPLEMENT = {"A": "T", "a": "T", "C": "G", "c": "G", "G": "C", "g": "C",
              "T": "A", "t": "A"}


def encode(seq: str) -> np.ndarray:
    """ASCII string -> uint8 codes (0..3, N/other=4)."""
    return NT4_TABLE[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]


def decode(codes: np.ndarray) -> str:
    return "".join("ACGTN"[c] for c in codes)


def reverse_complement_str(seq: str) -> str:
    """Reverse complement keeping the reference's match_table behavior
    (uppercase output; reference src/BwtIndexer.h:236-245)."""
    return "".join(COMPLEMENT.get(c, "N") for c in reversed(seq))


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement 0..3 codes; 4 (N) maps to 4."""
    out = codes[::-1].copy()
    mask = out < 4
    out[mask] = 3 - out[mask]
    return out


class Lrand48:
    """Exact replica of glibc's lrand48 LCG for deterministic N filling."""

    A = 0x5DEECE66D
    C = 0xB
    MASK = (1 << 48) - 1

    def __init__(self, seed: int = 11):
        self.x = ((seed & 0xFFFFFFFF) << 16) | 0x330E

    def next(self) -> int:
        self.x = (self.A * self.x + self.C) & self.MASK
        return (self.x >> 17) & 0x7FFFFFFF
