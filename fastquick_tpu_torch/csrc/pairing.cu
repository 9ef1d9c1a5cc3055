// Kernel 6: bwape.c's pairing over a batch of read pairs.
//
// Replaces the pairing scan of fastquick_tpu/ops/pe_device.py:221
// pairing_sweep, a lax.scan over each pair's NK = 2 K merged occurrence
// entries (:391) and no pallas_call, which the port's plain version runs
// as a Python loop of ~80 torch operations a step (ops/pe_device.
// pairing_sweep_plain).  The expansion and the two stable sorts stay torch
// operations, as the reference package sorts with jnp.argsort outside its
// scan; this kernel takes the sorted entries.
//
// What bounds it on this card: each pair's sweep is a chain of dependent
// steps over its own entries (the best and second keys, the last forward
// entries), and the pairs are independent.  So one thread runs one pair's
// whole sweep and its result (csrc/pairing_body.cuh) with the state in
// registers: the keys as uint64_t, the counters, the chosen entries and
// the four last-forward slots.  Per reverse entry a thread does up to two
// hashes, key compares and selects; the planes are read once (8 bytes an
// entry).
// The float32 insert-size penalty comes as an integer table the wrapper
// builds with the plain version's own torch operations, so the kernel
// does no float arithmetic at all and equals the plain version by
// construction.
#include <cuda_runtime.h>

#include "pairing_body.cuh"

#define FQ_PAIR_THREADS 128

__global__ void __launch_bounds__(FQ_PAIR_THREADS)
    fq_pairing_kernel(int P, int NK, const int32_t* pos_s,
                      const int32_t* ent_s, const int32_t* se,
                      const int32_t* pen, const int32_t* g_log_n,
                      FqPairParams prm, int32_t* out, int32_t* chg) {
  const int p = blockIdx.x * FQ_PAIR_THREADS + threadIdx.x;
  if (p >= P) return;
  chg[p] = fq_pair_sweep(p, P, NK, pos_s, ent_s, se, pen, g_log_n, prm, out);
}

// pos_s/ent_s: (P, NK) int32; se/out: (2, 8, P) int32; pen: the penalty
// table (int32, high_b + 1 entries when has_high); g_log_n: (256,) int32;
// chg: (P,) int32 (device memory).
extern "C" int fq_pairing_launch(int P, int NK, const int32_t* pos_s,
                                 const int32_t* ent_s, const int32_t* se,
                                 const int32_t* pen, const int32_t* g_log_n,
                                 int has_high, long long high_b,
                                 int max_isize, int s_mm, int32_t* out,
                                 int32_t* chg, void* stream) {
  if (P <= 0) return 0;
  const FqPairParams prm = {has_high, (int64_t)high_b, max_isize, s_mm};
  const int blocks = (P + FQ_PAIR_THREADS - 1) / FQ_PAIR_THREADS;
  fq_pairing_kernel<<<blocks, FQ_PAIR_THREADS, 0, (cudaStream_t)stream>>>(
      P, NK, pos_s, ent_s, se, pen, g_log_n, prm, out, chg);
  return (int)cudaGetLastError();
}
