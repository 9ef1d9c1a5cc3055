// Kernel 5: the drand48 reservoir draw of a batch of hit lists.
//
// Replaces fastquick_tpu/ops/drand48_device.py:167 aln2seq_draw_scan, a
// lax.scan over the reads with a while_loop over each read's best class
// and no pallas_call: the TPU has no int64 or float64, so it rode the
// 48-bit LCG on 12-bit limbs in int32 and reduced each double rounding to
// an exact integer test.  The card has both, so the walk computes what C
// computes: a uint64 LCG and one __dmul_rn a comparison or offset, built
// without --use_fast_math.
//
// What bounds it on this card: the stream is sequential by construction,
// so one thread walks the whole batch, and a draw is a chain of ~10
// dependent integer and double operations (the LCG's 64-bit multiply, the
// double multiply, the compare).  Bytes and operations are far below the
// card's rates.  So a block of FQ_DRAND_TILE threads loads a tile of
// reads at a time in parallel (each thread counts its read's best class
// and keeps its first row in shared memory), and thread 0 then walks the
// tile from shared memory; only a best class of more than one row reads
// global memory inside the walk.
#include <cuda_runtime.h>

#include "drand48_body.cuh"

#define FQ_DRAND_TILE 1024

__global__ void __launch_bounds__(FQ_DRAND_TILE)
    fq_drand48_kernel(const int32_t* n_aln, const int32_t* alns, int N,
                      const int32_t* state_in, int32_t* f0, int32_t* row,
                      int32_t* state_out) {
  __shared__ int32_t nb[FQ_DRAND_TILE];
  __shared__ int32_t first[FQ_DRAND_TILE * 3];
  const int t = threadIdx.x;
  uint64_t x = 0;
  if (t == 0) x = fq_drand_load(state_in);
  for (int base = 0; base < N; base += FQ_DRAND_TILE) {
    const int r = base + t;
    if (r < N) {
      const int32_t* rows = alns + (int64_t)r * FQ_DRAND_A_MAX * 3;
      nb[t] = fq_drand_best(rows, n_aln[r]);
      first[3 * t] = rows[0];
      first[3 * t + 1] = rows[1];
      first[3 * t + 2] = rows[2];
    }
    __syncthreads();
    if (t == 0) {
      const int n = min(FQ_DRAND_TILE, N - base);
      for (int i = 0; i < n; ++i) {
        const int ri = base + i;
        fq_drand_read(x, nb[i], first + 3 * i,
                      alns + (int64_t)ri * FQ_DRAND_A_MAX * 3, f0 + ri,
                      row + ri);
      }
    }
    __syncthreads();
  }
  if (t == 0) fq_drand_store(x, state_out);
}

// n_aln: (N,) int32; alns: (N, 48, 3) int32 hit rows; state_in/state_out:
// (4,) int32 12-bit limbs (device memory); outputs f0/row: (N,) int32.
extern "C" int fq_drand48_launch(const int32_t* n_aln, const int32_t* alns,
                                 int N, const int32_t* state_in, int32_t* f0,
                                 int32_t* row, int32_t* state_out,
                                 void* stream) {
  fq_drand48_kernel<<<1, FQ_DRAND_TILE, 0, (cudaStream_t)stream>>>(
      n_aln, alns, N, state_in, f0, row, state_out);
  return (int)cudaGetLastError();
}
