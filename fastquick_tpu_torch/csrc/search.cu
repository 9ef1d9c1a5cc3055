// Kernel 2: the best-first inexact FM search (bwt_match_gap) of a chunk.
//
// Replaces the Pallas _resident_kernel (fastquick_tpu/ops/search_pallas.py:773,
// driven by resident_search :1469).  The TPU kernel kept 1024 lanes of
// per-read state in VMEM as transposed (NP, B) planes, advanced them in
// lockstep with one-hot passes and flushed/refilled lanes in-kernel.  Here
// one thread runs one read to its end (search_body.cuh), and a read's
// result does not depend on its thread, its workspace's history or the
// order reads are taken, which tests/test_torch_search.py pins.
//
// What bounds it on this card: a launch lasts as long as its longest read
// (1,537 steps at the step cap), and a step of that read costs the latency
// of one warp's step.  The 32 reads of a warp take different paths (pop,
// chain base, hit, expansion with up to 9 pushes), and a lone warp runs
// their union as a chain of dependent instructions and loads; bytes and
// operations are far below the card's rates.  On the card the time was
// nearly flat in the warps an SM holds and fell with the instructions of a
// step (PERF.md).  So:
//
// - a step starts its loads in two rounds, the popped entry and then one
//   batch for every path (width and seed-width rows, two FM table rows,
//   the read base), and the rank counts of all four bases of both rows
//   are shared by the chain and the expansion (fm_count4);
// - the children of an expansion are a bit mask built in closed form, so
//   their count and bucket check come before any push and the pushes loop
//   over the children that exist (no local-memory child array);
// - one thread a read, in blocks of 128;
// - a chain length CH > 1 (bases of the exact walk a step) runs as a second
//   kernel, fq_search_chain_kernel, so the CH = 1 kernel compiles to the
//   same code as before the chain length was added;
// - each thread's 128 bucket heads in shared memory, interleaved over the
//   block's threads so a warp's accesses fall in distinct banks; its pool
//   and free stack are a slab per read in global memory.  A level of
//   pool slots in shared memory, and a persistent grid that pulls reads
//   from a counter, were measured and did not pay (PERF.md).
#include <cuda_runtime.h>

#include "search_body.cuh"

#define FQ_SEARCH_THREADS 128

// dynamic shared memory of a block: the bucket heads of each thread
static const size_t kSearchSmem =
    (size_t)FQ_SEARCH_THREADS * sizeof(int16_t) * FQ_NBUCK;

template <bool kChain>
__device__ __forceinline__ void fq_search_block(const FmView& fm,
                                                const SearchParams& P,
                                                const FqChunk& ck,
                                                FqSlot* pool, uint16_t* freel,
                                                const FqOut& out) {
  extern __shared__ int16_t fq_heads[];
  const int t = threadIdx.x;
  const int rid = blockIdx.x * FQ_SEARCH_THREADS + t;
  if (rid >= ck.N) return;
  const FqWork w = {pool + (int64_t)rid * P.NP, freel + (int64_t)rid * P.NP,
                    fq_heads + t, nullptr, FQ_SEARCH_THREADS};
  fq_resident_read<kChain>(fm, P, ck, rid, w, out);
}

__global__ void __launch_bounds__(FQ_SEARCH_THREADS)
    fq_search_kernel(FmView fm, SearchParams P, FqChunk ck, FqSlot* pool,
                     uint16_t* freel, FqOut out) {
  fq_search_block<false>(fm, P, ck, pool, freel, out);
}

__global__ void __launch_bounds__(FQ_SEARCH_THREADS)
    fq_search_chain_kernel(FmView fm, SearchParams P, FqChunk ck,
                           FqSlot* pool, uint16_t* freel, FqOut out) {
  fq_search_block<true>(fm, P, ck, pool, freel, out);
}

// The one-program step's retry of its first pass's pool overflows at a
// deeper slab (ops/host_redo.py): the same body under a name of its own,
// so a trace tells its launches from the passes' search launches.
template <bool kChain>
__global__ void __launch_bounds__(FQ_SEARCH_THREADS)
    fq_search_retry_kernel(FmView fm, SearchParams P, FqChunk ck,
                           FqSlot* pool, uint16_t* freel, FqOut out) {
  fq_search_block<kChain>(fm, P, ck, pool, freel, out);
}

// The share of each SM's unified L1/shared memory to give shared memory
// for `blocks` blocks: what the blocks an SM will hold need (1 KB a block
// is the system's), so the rest stays L1 cache for the width rows, the
// pool slabs and the FM table rows.
template <typename K>
static cudaError_t fq_search_carveout(K kernel, int blocks) {
  int dev = 0, sms = 0, smem_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e != cudaSuccess) return e;
  const size_t per_sm = (blocks + sms - 1) / sms;
  const size_t need = per_sm * (kSearchSmem + 1024);
  const int pct = (int)((100 * need + smem_sm - 1) / smem_sm);
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              pct < 100 ? pct : 100);
}

typedef void (*FqSearchKernel)(FmView, SearchParams, FqChunk, FqSlot*,
                               uint16_t*, FqOut);

static int fq_search_run(bool retry, const int32_t* tab,
                         const int32_t* fm_hp, const int32_t* sp,
                         const uint8_t* seqs, const int32_t* lens,
                         const int32_t* md, const int32_t* use_seed,
                         const int32_t* n_n, int N, int32_t* widths,
                         const int32_t* seed_w, void* pool, void* freel,
                         int32_t* alns, int32_t* n_aln, int32_t* fb,
                         int32_t* steps, int32_t* hwm, void* stream) {
  if (N > 0) {
    const int blocks = (N + FQ_SEARCH_THREADS - 1) / FQ_SEARCH_THREADS;
    const SearchParams P = search_params(sp);
    FqSearchKernel kernel;
    if (retry)
      kernel = P.CH > 1 ? fq_search_retry_kernel<true>
                        : fq_search_retry_kernel<false>;
    else
      kernel = P.CH > 1 ? fq_search_chain_kernel : fq_search_kernel;
    const cudaError_t e = fq_search_carveout(kernel, blocks);
    if (e != cudaSuccess) return (int)e;
    const FqChunk ck = {seqs, lens, md, use_seed, n_n, N, widths, seed_w};
    const FqOut out = {alns, n_aln, fb, steps, hwm};
    kernel<<<blocks, FQ_SEARCH_THREADS, kSearchSmem, (cudaStream_t)stream>>>(
        fm_view(tab, fm_hp), P, ck, (FqSlot*)pool, (uint16_t*)freel, out);
  }
  return (int)cudaGetLastError();
}

// seqs: (N, L) uint8 reversed codes; lens/md/use_seed/n_n: (N,) int32;
// widths: (2N, L+1, 2) int32 (strand-0 rows first), updated in place;
// seed_w: (2N, SL+1, 2); pool: (N, NP) slots of 4 int32; freel: (N, NP)
// uint16; alns: (N, 48, 3) int32, zeroed; outputs n_aln/fb/steps/hwm:
// (N,).  sp: SearchParams host array; its chain length CH picks the kernel.
extern "C" int fq_search_launch(
    const int32_t* tab, const int32_t* fm_hp, const int32_t* sp,
    const uint8_t* seqs, const int32_t* lens, const int32_t* md,
    const int32_t* use_seed, const int32_t* n_n, int N, int32_t* widths,
    const int32_t* seed_w, void* pool, void* freel, int32_t* alns,
    int32_t* n_aln, int32_t* fb, int32_t* steps, int32_t* hwm,
    void* stream) {
  return fq_search_run(false, tab, fm_hp, sp, seqs, lens, md, use_seed, n_n,
                       N, widths, seed_w, pool, freel, alns, n_aln, fb, steps,
                       hwm, stream);
}

// fq_search_launch's arguments, launched as fq_search_retry_kernel.
extern "C" int fq_search_retry_launch(
    const int32_t* tab, const int32_t* fm_hp, const int32_t* sp,
    const uint8_t* seqs, const int32_t* lens, const int32_t* md,
    const int32_t* use_seed, const int32_t* n_n, int N, int32_t* widths,
    const int32_t* seed_w, void* pool, void* freel, int32_t* alns,
    int32_t* n_aln, int32_t* fb, int32_t* steps, int32_t* hwm,
    void* stream) {
  return fq_search_run(true, tab, fm_hp, sp, seqs, lens, md, use_seed, n_n,
                       N, widths, seed_w, pool, freel, alns, n_aln, fb, steps,
                       hwm, stream);
}
