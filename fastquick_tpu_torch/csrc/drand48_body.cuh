// The reference's drand48 reservoir draw (bwa_aln2seq_core, libbwa/
// bwase.c:19-44) over a batch of hit lists in read order, as C computes
// it: a 48-bit LCG state in a uint64 and IEEE doubles.  One sequential
// stream runs across the batch (a read's draws depend on how many draws
// the reads before it took), so the walk is one thread's work; the
// kernel (drand48.cu) and the host build (host_kernels.cpp) share it.
#pragma once

#include "fq_common.cuh"

#define FQ_DRAND_A_MAX 48  // hit rows a read (ops/search_kernels.A_MAX)
#define FQ_DRAND_MASK 0xFFFFFFFFFFFFull  // 2^48 - 1

// x' = (0x5DEECE66D * x + 0xB) mod 2^48
FQ_HD uint64_t fq_drand_next(uint64_t x) {
  return (0x5DEECE66Dull * x + 0xBull) & FQ_DRAND_MASK;
}

// drand48()'s value times v, one IEEE double multiply rounded to nearest
// (x * 2^-48 is exact; no contraction with anything after it)
FQ_HD double fq_drand_mul(uint64_t x, double v) {
#if defined(__CUDA_ARCH__)
  return __dmul_rn((double)x * 0x1p-48, v);
#else
  return ((double)x * 0x1p-48) * v;
#endif
}

// The state as the reference package's four 12-bit limbs, and back.
FQ_HD uint64_t fq_drand_load(const int32_t* limbs) {
  uint64_t x = 0;
  for (int i = 3; i >= 0; --i) x = (x << 12) | (uint64_t)(limbs[i] & 0xFFF);
  return x;
}

FQ_HD void fq_drand_store(uint64_t x, int32_t* limbs) {
  for (int i = 0; i < 4; ++i) limbs[i] = (int32_t)((x >> (12 * i)) & 0xFFF);
}

// The best class of a read's n hit rows [packed, k, l]: how many of them
// carry the first row's score (bits 19..25 of the packed word).
FQ_HD int fq_drand_best(const int32_t* rows, int n) {
  n = fq_clamp(n, 0, FQ_DRAND_A_MAX);
  if (n == 0) return 0;
  const int best = (rows[0] >> 19) & 127;
  int nb = 0;
  for (int i = 0; i < n; ++i) nb += ((rows[3 * i] >> 19) & 127) == best;
  return nb;
}

// One read's draw over its first nb rows (row 0 passed apart, as the
// kernel holds it in shared memory): each row is accepted with
// drand48() * (w + cnt) > cnt, and an accepted row takes a second draw
// for its SA-row offset (bwtint_t)(w * drand48()).  f0/row stay 0 when no
// row is accepted (C's calloc'd bwa_seq_t).
FQ_HD void fq_drand_read(uint64_t& x, int nb, const int32_t* row0,
                         const int32_t* rows, int32_t* f0, int32_t* row) {
  int32_t f = 0, r = 0, cnt = 0;
  for (int i = 0; i < nb; ++i) {
    const int32_t* e = i == 0 ? row0 : rows + 3 * i;
    const int32_t w = e[2] - e[1] + 1;
    const uint64_t x1 = fq_drand_next(x);
    const bool acc = fq_drand_mul(x1, (double)(w + cnt)) > (double)cnt;
    if (acc) {
      const uint64_t x2 = fq_drand_next(x1);
      f = e[0];
      r = e[1] + (int32_t)(uint64_t)fq_drand_mul(x2, (double)w);
      x = x2;
    } else {
      x = x1;
    }
    cnt += w;
  }
  *f0 = f;
  *row = r;
}
