// The reference's drand48 reservoir draw (bwa_aln2seq_core, libbwa/
// bwase.c:19-44) over a batch of hit lists in read order, as C computes
// it: a 48-bit LCG state in a uint64 and IEEE doubles.  One sequential
// stream runs across the batch, but most of its consumption is known
// before the walk: a read whose best class is empty takes no draw, and a
// read whose best class is one row of width >= 1 ("single") takes exactly
// two, unless its first draw is 0 (0 * w > 0 fails: one draw, nothing
// selected).  So the walk visits only the other ("serial") reads and
// crosses each run of m single reads with one affine jump of 2m steps
// (x -> A_2m x + C_2m mod 2^48); each single read then draws from its own
// start state in parallel, and a single read whose first draw is 0 ends
// the speculation there: the walk resumes at the next read from state 0.
// Inside the walk a row's acceptance test, one double multiply and
// compare of the draw, is a threshold on the draw's 48-bit state (IEEE
// rounding is monotone), found beforehand by bisection, so the walk's
// chain is integer work only.  The kernel (drand48.cu) and the host build
// (host_kernels.cpp) share these pieces and the sizes below.
#pragma once

#include "fq_common.cuh"

#define FQ_DRAND_A_MAX 48  // hit rows a read (ops/search_kernels.A_MAX)
#define FQ_DRAND_MASK 0xFFFFFFFFFFFFull  // 2^48 - 1
#define FQ_DRAND_A 0x5DEECE66Dull
#define FQ_DRAND_C 0xBull
// reads a tile; the serial reads' best-class rows a tile holds at most
// (a tile ends early where the next serial read's rows would not fit)
#define FQ_DRAND_TILE 1024
#define FQ_DRAND_ROWS 4096

// read classes
#define FQ_DRAND_EMPTY 0
#define FQ_DRAND_SINGLE 1
#define FQ_DRAND_SERIAL 2

// x' = (0x5DEECE66D * x + 0xB) mod 2^48
FQ_HD uint64_t fq_drand_next(uint64_t x) {
  return (FQ_DRAND_A * x + FQ_DRAND_C) & FQ_DRAND_MASK;
}

// The affine map of n steps, x -> a x + c mod 2^48, by square and
// multiply over the bits of n (powers of one map commute).
FQ_HD void fq_drand_power(uint32_t n, uint64_t& a, uint64_t& c) {
  uint64_t ra = 1, rc = 0, pa = FQ_DRAND_A, pc = FQ_DRAND_C;
  while (n) {
    if (n & 1) {
      rc = (pa * rc + pc) & FQ_DRAND_MASK;
      ra = (pa * ra) & FQ_DRAND_MASK;
    }
    pc = (pa * pc + pc) & FQ_DRAND_MASK;
    pa = (pa * pa) & FQ_DRAND_MASK;
    n >>= 1;
  }
  a = ra;
  c = rc;
}

FQ_HD uint64_t fq_drand_apply(uint64_t a, uint64_t c, uint64_t x) {
  return (a * x + c) & FQ_DRAND_MASK;
}

// x advanced n < 2^FQ_DRAND_JUMP_BITS steps by the table of the 2^k-step
// maps (ta[k], tc[k]): one multiply-add a set bit of n.
#define FQ_DRAND_JUMP_BITS 12
FQ_HD uint64_t fq_drand_jump(const uint64_t* ta, const uint64_t* tc,
                             uint32_t n, uint64_t x) {
#pragma unroll
  for (int k = 0; k < FQ_DRAND_JUMP_BITS; ++k)
    if ((n >> k) & 1) x = fq_drand_apply(ta[k], tc[k], x);
  return x;
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

// A row's acceptance at the draw whose state is xl: drand48() * (w + cnt)
// > cnt, in C's int and double arithmetic.
FQ_HD bool fq_drand_accept(uint64_t xl, int32_t w, int32_t cnt) {
  return fq_drand_mul(xl, (double)(w + cnt)) > (double)cnt;
}

// fq_drand_accept(x, w, cnt) is monotone in x (the product is x * 2^-48
// times a fixed double, and rounding to nearest is monotone), so it is
// its value at x = 0 until a threshold T and the other value from T on.
// Returns T | (the value at 0) << 63, T in [1, 2^48] (2^48: never
// changes), by bisection over the exact test.  Where w and cnt are
// positive, T lies within a unit or two of cnt 2^48 / (w + cnt) (the
// product's rounding moves it by less than (cnt / (w + cnt)) 2^-5), so
// the bisection starts from a window of 8 around that quotient once the
// test has confirmed the window's ends.
FQ_HD uint64_t fq_drand_threshold(int32_t w, int32_t cnt) {
  if (cnt == 0 && w >= 1) return 1;  // x * 2^-48 * w > 0 from x = 1 on
  const bool p0 = fq_drand_accept(0, w, cnt);
  uint64_t lo = 0, hi = FQ_DRAND_MASK + 1;  // test(lo) == p0; hi: changed
  const int32_t W = w + cnt;
  if (!p0 && w > 0 && cnt > 0 && W > 0) {
    const uint64_t c = (uint64_t)((double)cnt / (double)W * 0x1p48);
    const uint64_t a = c > 4 ? c - 4 : 0, b = c + 4;
    if (b <= FQ_DRAND_MASK && !fq_drand_accept(a, w, cnt) &&
        fq_drand_accept(b, w, cnt)) {
      lo = a;
      hi = b;
    }
  }
  while (hi - lo > 1) {
    const uint64_t mid = lo + ((hi - lo) >> 1);
    if (fq_drand_accept(mid, w, cnt) != p0)
      hi = mid;
    else
      lo = mid;
  }
  return hi | (uint64_t)p0 << 63;
}

// fq_drand_accept(x, w, cnt) from the row's threshold word.
FQ_HD bool fq_drand_pass(uint64_t x, uint64_t thr) {
  return (x >= (thr & ~(1ull << 63))) != (bool)(thr >> 63);
}

// The selected row's SA row from its offset draw's state xo.
FQ_HD int32_t fq_drand_offset(uint64_t xo, int32_t k, int32_t w) {
  return k + (int32_t)(uint64_t)fq_drand_mul(xo, (double)w);
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
#pragma unroll 4
  for (int i = 0; i < n; ++i) nb += ((rows[3 * i] >> 19) & 127) == best;
  return nb;
}

// A read's class from its best class nb and first row's width w0.
FQ_HD int fq_drand_class(int nb, int32_t w0) {
  if (nb == 0) return FQ_DRAND_EMPTY;
  return nb == 1 && w0 >= 1 ? FQ_DRAND_SINGLE : FQ_DRAND_SERIAL;
}

// One serial read's draw over its nb best-class rows (acceptance
// thresholds thr, SA rows k, widths w, packed words f): each row is
// accepted with drand48() * (w + cnt) > cnt, and an accepted row takes a
// second draw for its SA-row offset (bwtint_t)(w * drand48()).  f0/row
// stay 0 when no row is accepted (C's calloc'd bwa_seq_t).  The offset's
// double multiply is done once, for the last accepted row.
FQ_HD void fq_drand_walk(uint64_t& x, int nb, const uint64_t* thr,
                         const int32_t* k, const int32_t* w,
                         const int32_t* f, int32_t& f0, int32_t& row) {
  int isel = -1;
  uint64_t xsel = 0;
  for (int i = 0; i < nb; ++i) {
    const uint64_t x1 = fq_drand_next(x);
    const uint64_t x2 = fq_drand_next(x1);
    const bool acc = fq_drand_pass(x1, thr[i]);
    if (acc) {
      isel = i;
      xsel = x2;
    }
    x = acc ? x2 : x1;
  }
  f0 = isel >= 0 ? f[isel] : 0;
  row = isel >= 0 ? fq_drand_offset(xsel, k[isel], w[isel]) : 0;
}

// The state after a serial read's draws from its start state x (the walk's
// chain: an LCG step and an integer compare a row).
FQ_HD uint64_t fq_drand_chain(uint64_t x, int nb, const uint64_t* thr) {
#pragma unroll 4
  for (int i = 0; i < nb; ++i) {
    const uint64_t x1 = fq_drand_next(x);
    const uint64_t x2 = fq_drand_next(x1);
    x = fq_drand_pass(x1, thr[i]) ? x2 : x1;
  }
  return x;
}

// One single read's draw from its start state x (its row: packed word f,
// SA row k, width w >= 1).  Returns false, with nothing written, when the
// first draw is 0: that read takes one draw and selects nothing, and the
// speculation that it took two breaks there.
FQ_HD bool fq_drand_single(uint64_t x, int32_t f, int32_t k, int32_t w,
                           int32_t& f0, int32_t& row) {
  const uint64_t x1 = fq_drand_next(x);
  if (x1 == 0) return false;
  f0 = f;
  row = fq_drand_offset(fq_drand_next(x1), k, w);
  return true;
}
