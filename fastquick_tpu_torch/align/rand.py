"""Deterministic replicas of the C RNGs the reference relies on.

- drand48/lrand48 share one 48-bit LCG state seeded by srand48 (glibc);
  the align stage seeds srand48(bns->seed == 11) per mapper
  (reference src/BwtMapper.cpp:1279,1427,1817) and consumes drand48 in
  bwa_aln2seq_core's reservoir sampling (libbwa/bwase.c:19-44).
- statgen's Random (Mersenne twister) drives read downsampling; with the
  default --frac_samp 1.0 its values never exceed frac, so downsampling is
  a no-op and we only need it when frac < 1.
"""

from __future__ import annotations


class Rand48:
    """glibc [dsl]rand48 family on one shared state."""

    A = 0x5DEECE66D
    C = 0xB
    MASK = (1 << 48) - 1

    def __init__(self, seed: int = 11):
        self.srand48(seed)

    def srand48(self, seed: int) -> None:
        self.x = (((seed & 0xFFFFFFFF) << 16) | 0x330E) & self.MASK

    def _step(self) -> int:
        self.x = (self.A * self.x + self.C) & self.MASK
        return self.x

    def drand48(self) -> float:
        return self._step() / float(1 << 48)

    def lrand48(self) -> int:
        return (self._step() >> 17) & 0x7FFFFFFF


class MersenneRandom:
    """statgen Random (VerifyBamID/Random.cpp): MT19937 returning doubles
    in [0,1) via multiplier 1/(2^32-1) -- only exercised when frac < 1."""

    N = 624
    M = 397
    MATRIX_A = 0x9908B0DF
    UPPER = 0x80000000
    LOWER = 0x7FFFFFFF

    def __init__(self, seed: int = 0x7654321):
        self.mt = [0] * self.N
        self.mti = self.N + 1
        self.mult = 1.0 / 4294967295.0
        self._init_genrand(seed & 0xFFFFFFFF)

    def _init_genrand(self, s: int) -> None:
        self.mt[0] = s & 0xFFFFFFFF
        for i in range(1, self.N):
            self.mt[i] = (1812433253 * (self.mt[i - 1] ^ (self.mt[i - 1] >> 30)) + i) & 0xFFFFFFFF
        self.mti = self.N

    def _genrand_int32(self) -> int:
        if self.mti >= self.N:
            mt = self.mt
            for kk in range(self.N - self.M):
                y = (mt[kk] & self.UPPER) | (mt[kk + 1] & self.LOWER)
                mt[kk] = mt[kk + self.M] ^ (y >> 1) ^ (self.MATRIX_A if y & 1 else 0)
            for kk in range(self.N - self.M, self.N - 1):
                y = (mt[kk] & self.UPPER) | (mt[kk + 1] & self.LOWER)
                mt[kk] = mt[kk + (self.M - self.N)] ^ (y >> 1) ^ (self.MATRIX_A if y & 1 else 0)
            y = (mt[self.N - 1] & self.UPPER) | (mt[0] & self.LOWER)
            mt[self.N - 1] = mt[self.M - 1] ^ (y >> 1) ^ (self.MATRIX_A if y & 1 else 0)
            self.mti = 0
        y = self.mt[self.mti]
        self.mti += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & 0xFFFFFFFF

    def next(self) -> float:
        return self._genrand_int32() * self.mult
