// Kernel 2: the best-first inexact FM search (bwt_match_gap) of a chunk.
//
// Replaces the Pallas _resident_kernel (fastquick_tpu/ops/search_pallas.py:773,
// driven by resident_search :1469).  The TPU kernel kept 1024 lanes of
// per-read state in VMEM as transposed (NP, B) planes, advanced them in
// lockstep with one-hot passes and flushed/refilled lanes in-kernel.  None
// of that carries over: one thread runs one read to completion
// (search_body.cuh), with its pool, free stack, bucket heads and hit rows
// in a per-read slab of global memory allocated by the wrapper (~18 KB a
// read at NP = 1024).  The per-read result does not depend on which reads
// run beside it, which tests/test_torch_search.py pins on the plain
// version.  The work is a data-dependent chain of L2-resident FM rank
// queries and pool accesses, so latency and warp divergence bound it, not
// device-memory bytes.
#include <cuda_runtime.h>

#include "search_body.cuh"

__global__ void fq_search_kernel(
    FmView fm, SearchParams P, const uint8_t* __restrict__ seqs,
    const int32_t* __restrict__ lens, const int32_t* __restrict__ md,
    const int32_t* __restrict__ use_seed, const int32_t* __restrict__ n_n,
    int N, int32_t* widths, const int32_t* __restrict__ seed_w,
    FqSlot* pool, uint16_t* freel, int16_t* heads, int32_t* alns,
    int32_t* n_aln, int32_t* fb, int32_t* steps) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  const int64_t LW = 2 * (P.L + 1), SW = 2 * (P.SL + 1);
  const SearchOut o = search_read(
      fm, P, seqs + (int64_t)r * P.L, lens[r], md[r], use_seed[r], n_n[r],
      widths + r * LW, widths + (N + r) * LW, seed_w + r * SW,
      seed_w + (N + r) * SW, pool + (int64_t)r * P.NP,
      freel + (int64_t)r * P.NP, heads + (int64_t)r * FQ_NBUCK,
      alns + (int64_t)r * FQ_A_MAX * 3);
  n_aln[r] = o.n_aln;
  fb[r] = o.fb;
  steps[r] = o.steps;
}

// seqs: (N, L) uint8 reversed codes; lens/md/use_seed/n_n: (N,) int32;
// widths: (2N, L+1, 2) int32 (strand-0 rows first), updated in place;
// seed_w: (2N, SL+1, 2); pool: (N, NP) slots of 4 int32; freel: (N, NP)
// uint16; heads: (N, 128) int16; alns: (N, 48, 3) int32, zeroed;
// outputs n_aln/fb/steps: (N,).  sp: SearchParams host array.
extern "C" int fq_search_launch(
    const int32_t* tab, const int32_t* fm_hp, const int32_t* sp,
    const uint8_t* seqs, const int32_t* lens, const int32_t* md,
    const int32_t* use_seed, const int32_t* n_n, int N, int32_t* widths,
    const int32_t* seed_w, void* pool, void* freel, void* heads,
    int32_t* alns, int32_t* n_aln, int32_t* fb, int32_t* steps,
    void* stream) {
  if (N > 0) {
    const int threads = 64;
    const int blocks = (N + threads - 1) / threads;
    fq_search_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        fm_view(tab, fm_hp), search_params(sp), seqs, lens, md, use_seed,
        n_n, N, widths, seed_w, (FqSlot*)pool, (uint16_t*)freel,
        (int16_t*)heads, alns, n_aln, fb, steps);
  }
  return (int)cudaGetLastError();
}
