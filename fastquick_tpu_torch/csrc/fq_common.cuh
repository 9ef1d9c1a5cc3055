// Shared pieces of the port's kernels: the host/device qualifier, popcount
// and the FM-index rank query over DeviceFM.kernel_table().
//
// Every per-item body in this directory is written once as FQ_HD functions:
// nvcc builds them into the sm_90a kernels (width.cu, search.cu, scan.cu,
// sw.cu) and g++ builds the same bodies into a small host library
// (host_kernels.cpp) that the CPU tests hold against the plain PyTorch
// versions.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define FQ_HD __host__ __device__ __forceinline__
#else
#define FQ_HD static inline
#endif

FQ_HD int fq_popc(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// index of the lowest set bit of a nonzero word
FQ_HD int fq_ctz(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __ffs(x) - 1;
#else
  return __builtin_ctz(x);
#endif
}

// a block-wide barrier in device code (host builds run one item at a time)
FQ_HD void fq_sync_block() {
#if defined(__CUDA_ARCH__)
  __syncthreads();
#endif
}

FQ_HD int fq_min(int a, int b) { return a < b ? a : b; }
// v[c] of four values by a data-dependent c in 0..3, as selects: an array
// indexed at run time would go to local memory on the device
FQ_HD int fq_pick4(const int v[4], int c) {
  return c == 0 ? v[0] : c == 1 ? v[1] : c == 2 ? v[2] : v[3];
}
FQ_HD int fq_max(int a, int b) { return a > b ? a : b; }
FQ_HD int fq_clamp(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Kernel view of a DeviceFM: `tab` holds 2 * nbp rows of 16 int32
// [occ0..3, word0..7, pad x4] (forward index rows first), each word
// packing 16 BWT bases at bits 2 * (15 - j).
struct FmView {
  const int32_t* tab;
  int n, nbp;
  int primary[2];
  int L2[2][4];
};

// hp = DeviceFM.host_params(): [n, nbp, primary0, primary1, L2 fwd x4,
// L2 rev x4]
FQ_HD FmView fm_view(const int32_t* tab, const int32_t* hp) {
  FmView f;
  f.tab = tab;
  f.n = hp[0];
  f.nbp = hp[1];
  f.primary[0] = hp[2];
  f.primary[1] = hp[3];
  for (int s = 0; s < 2; ++s)
    for (int c = 0; c < 4; ++c) f.L2[s][c] = hp[4 + 4 * s + c];
  return f;
}

// L2[sel][c] (selects only, for the same reason as fq_pick4)
FQ_HD int fm_L2(const FmView& fm, int sel, int c) {
  const int fwd = fq_pick4(fm.L2[0], c), rev = fq_pick4(fm.L2[1], c);
  return sel ? rev : fwd;
}

// Position of BWT row bound k + 1 of index `sel` in the Occ rows
// (bwt_occ: rows [0..k], sentinel row removed): its block is pos >> 7, the
// bases of the block to count pos & 127.
FQ_HD int fm_pos(const FmView& fm, int sel, int k) {
  const int kk = k + 1;
  const int kp = kk - (kk > (sel ? fm.primary[1] : fm.primary[0]) ? 1 : 0);
  return fq_clamp(kp, 0, fm.n);
}

// Occ block `blk` of index `sel` loaded into r[0..11] (occ[4], words[8])
FQ_HD void fm_row(const FmView& fm, int sel, int blk, int32_t r[12]) {
  const int32_t* row = fm.tab + ((int64_t)sel * fm.nbp + blk) * 16;
#if defined(__CUDA_ARCH__)
  const int4* q = reinterpret_cast<const int4*>(row);
  int4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
  r[8] = c.x; r[9] = c.y; r[10] = c.z; r[11] = c.w;
#else
  for (int i = 0; i < 12; ++i) r[i] = row[i];
#endif
}

// Row of the Occ block holding BWT row bound k + 1 of index `sel`, loaded
// into r[0..11]; returns the bases of the block to count.
FQ_HD int fm_load(const FmView& fm, int sel, int k, int32_t r[12]) {
  const int kp = fm_pos(fm, sel, k);
  fm_row(fm, sel, kp >> 7, r);
  return kp & 127;
}

// occ of base c in the first `rem` bases of the loaded block, plus the
// block checkpoint (2-bit equality masks + popcount, bwt.h __occ_aux).
// All eight words with a branch-free mask each and the checkpoint by
// selects: no run-time trip count and no indexed array, so the row stays
// in registers.
FQ_HD int fm_count(const int32_t r[12], int rem, int c) {
  const uint32_t pat = (uint32_t)c * 0x55555555u;  // c repeated 16 times
  int cnt = fq_pick4(r, c);
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const int p = rem - 16 * w;  // bases of word w still to count
    const uint32_t m = p >= 16 ? 0x55555555u
                       : p > 0 ? 0x55555555u << (32 - 2 * p)
                               : 0u;
    const uint32_t x = (uint32_t)r[4 + w] ^ pat;
    cnt += fq_popc(~(x | (x >> 1)) & m);
  }
  return cnt;
}

// occ of all four bases in the first `rem` bases of the loaded block plus
// the checkpoints, in one pass: per word the fields' low bits (A), high
// bits (B) and both (C) are counted, so base 3 occurs C times, 1 A - C,
// 2 B - C and 0 rem - A - B + C times
FQ_HD void fm_count4(const int32_t r[12], int rem, int out[4]) {
  int A = 0, B = 0, C = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const int p = rem - 16 * w;  // bases of word w still to count
    const uint32_t m = p >= 16 ? 0x55555555u
                       : p > 0 ? 0x55555555u << (32 - 2 * p)
                               : 0u;
    const uint32_t lo = (uint32_t)r[4 + w] & m;
    const uint32_t hi = ((uint32_t)r[4 + w] >> 1) & m;
    A += fq_popc(lo);
    B += fq_popc(hi);
    C += fq_popc(lo & hi);
  }
  out[0] = r[0] + rem - A - B + C;
  out[1] = r[1] + A - C;
  out[2] = r[2] + B - C;
  out[3] = r[3] + C;
}
