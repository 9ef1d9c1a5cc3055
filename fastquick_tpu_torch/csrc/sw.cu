// Kernel 3: the local Smith-Waterman forward pass of mate rescue.
//
// Replaces the Pallas _sw_kernel (fastquick_tpu/ops/sw_pallas.py:52, driven
// by sw_forward_batch :145).  The TPU kernel resolved the horizontal gap of
// each row with a max-plus prefix-scan fixpoint across 128-lane vectors.
// Here one thread runs one job's serial row recurrence (sw_body.cuh), the
// exact freeze-F order of stdaln.c.  Inputs and the h/e scratch rows are
// stored interleaved ([position][job]), so the threads of a warp, which
// walk the same (i, j) cell of their own jobs together, touch consecutive
// words.  At ~15 integer operations per cell and one read-modify-write of
// two scratch words per cell served mostly by L1/L2, the kernel is bound by
// operations and by its low parallelism (one thread per job).
#include <cuda_runtime.h>

#include "sw_body.cuh"

__global__ void fq_sw_kernel(const uint8_t* __restrict__ refs_t,
                             const uint8_t* __restrict__ qs_t,
                             const int32_t* __restrict__ rlens,
                             const int32_t* __restrict__ qlens, int B,
                             int32_t* h_t, int32_t* e_t,
                             int32_t* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int32_t res[4];
  sw_forward_job(refs_t + b, qs_t + b, B, rlens[b], qlens[b], h_t + b,
                 e_t + b, res);
  for (int c = 0; c < 4; ++c) out[4 * b + c] = res[c];
}

// refs_t: (RL, B) uint8, qs_t: (QL, B) uint8 (transposed codes);
// rlens/qlens: (B,) int32 (rlens <= RL, qlens <= QL); h_t/e_t: (RL, B)
// int32 scratch; out: (B, 4) int32 [best, end_i, end_j, 0].
extern "C" int fq_sw_launch(const uint8_t* refs_t, const uint8_t* qs_t,
                            const int32_t* rlens, const int32_t* qlens,
                            int B, int32_t* h_t, int32_t* e_t, int32_t* out,
                            void* stream) {
  if (B > 0) {
    const int threads = 64;
    const int blocks = (B + threads - 1) / threads;
    fq_sw_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        refs_t, qs_t, rlens, qlens, B, h_t, e_t, out);
  }
  return (int)cudaGetLastError();
}
