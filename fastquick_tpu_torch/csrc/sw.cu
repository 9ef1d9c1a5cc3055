// Kernel 3: the local Smith-Waterman forward pass of mate rescue.
//
// Replaces the Pallas _sw_kernel (fastquick_tpu/ops/sw_pallas.py:52, driven
// by sw_forward_batch :145).  The TPU kernel resolved the horizontal gap of
// each row with a max-plus prefix-scan fixpoint across 128-lane vectors.
//
// What bounds it on this card: ~12 integer operations a cell and a chain
// of dependent cells along each row and column; the bytes (the two
// sequences in, four words out) are negligible.  The design keeps every
// cell in registers and puts 32 lanes on each job: one warp per job (one
// block of one warp), an anti-diagonal wavefront over strips of 32 query
// rows (sw_body.cuh).  Per step each lane takes the row above's H and E
// from its neighbour by __shfl_up_sync and reads one ref code (a warp's
// loads touch 32 consecutive bytes); lane 0 reads the previous strip's last
// row from a column buffer of 2 rl int32 in shared memory, which lane 31
// writes.  Nothing per cell touches global memory.  A strip takes rl + 31
// steps, so a job of ql rows takes ceil(ql / 32) (rl + 31) steps; the
// first maximum is kept per lane and picked by a warp reduction.
#include <cuda_runtime.h>

#include "sw_body.cuh"

#define FQ_FULL_WARP 0xFFFFFFFFu

__global__ void __launch_bounds__(FQ_SW_STRIP) fq_sw_kernel(
    const uint8_t* __restrict__ refs, const uint8_t* __restrict__ qs,
    const int32_t* __restrict__ rlens, const int32_t* __restrict__ qlens,
    int RL, int QL, int32_t* __restrict__ out) {
  extern __shared__ int32_t fq_col[];
  const int b = blockIdx.x, t = threadIdx.x;
  const uint8_t* ref = refs + (int64_t)b * RL;
  const uint8_t* q = qs + (int64_t)b * QL;
  const int rl = rlens[b], ql = qlens[b];
  SwLane L;
  sw_lane_job(L);
  for (int s = 0; FQ_SW_STRIP * s < ql; ++s) {
    const int i = FQ_SW_STRIP * s + t;
    sw_lane_row(L, i < ql ? q[i] : 4);
    const int steps = sw_strip_steps(rl, ql, s);
    for (int tau = 0; tau < steps; ++tau) {
      const int up_h = __shfl_up_sync(FQ_FULL_WARP, L.h, 1);
      const int up_e = __shfl_up_sync(FQ_FULL_WARP, L.e, 1);
      sw_lane_step(L, t, s, tau, rl, ql, ref, up_h, up_e, fq_col);
    }
    __syncwarp();  // the column buffer is complete for the next strip
  }
  int best = L.best, bi = L.bi, bj = L.bj;
  for (int o = FQ_SW_STRIP / 2; o > 0; o >>= 1) {
    const int b2 = __shfl_xor_sync(FQ_FULL_WARP, best, o);
    const int i2 = __shfl_xor_sync(FQ_FULL_WARP, bi, o);
    const int j2 = __shfl_xor_sync(FQ_FULL_WARP, bj, o);
    if (sw_before(b2, i2, j2, best, bi, bj)) {
      best = b2;
      bi = i2;
      bj = j2;
    }
  }
  if (t == 0) {
    out[4 * b] = best;
    out[4 * b + 1] = bi;
    out[4 * b + 2] = bj;
    out[4 * b + 3] = 0;
  }
}

// refs: (B, RL) uint8 codes, qs: (B, QL) uint8; rlens/qlens: (B,) int32
// (rlens <= RL, qlens <= QL); out: (B, 4) int32 [best, end_i, end_j, 0].
extern "C" int fq_sw_launch(const uint8_t* refs, const uint8_t* qs,
                            const int32_t* rlens, const int32_t* qlens,
                            int B, int RL, int QL, int32_t* out,
                            void* stream) {
  if (B > 0) {
    const size_t smem = sizeof(int32_t) * 2 * (size_t)RL;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          fq_sw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    fq_sw_kernel<<<B, FQ_SW_STRIP, smem, (cudaStream_t)stream>>>(
        refs, qs, rlens, qlens, RL, QL, out);
  }
  return (int)cudaGetLastError();
}
