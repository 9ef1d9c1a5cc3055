// Kernel 4: the scan path (`FQ_BS_PALLAS=2`) of one chunk in one launch:
// B persistent lanes, each advanced K_INNER lockstep steps a round, with
// the flush and refill of lanes and the loop condition between rounds.
//
// Replaces the Pallas v1 scan kernel _kernel (fastquick_tpu/ops/
// search_pallas.py:154, launched by _scan_call :612 for inner_scan_pallas
// :650).  The TPU kernel held the lanes' state as transposed (W, B) VMEM
// planes and advanced all B lanes K_INNER steps in lockstep with one-hot
// passes; the outer round (flush of finished lanes, refill with the next
// reads, the loop condition) ran in XLA between launches.  Here one thread
// runs one lane through every round of the chunk, with the semantics of
// ops/batch_search.scan_search over PlainLanes, its plain version.
//
// What bounds it on this card: a round lasts as long as the slowest warp's
// K_INNER steps, each a chain of dependent L2-resident rank queries and
// pool accesses as in search.cu; 1,024 lanes fill only a few SMs, and
// bytes and operations are far below the card's rates.  A round of the
// old design also paid a launch, a 128-byte lane record loaded and stored
// per lane, about ten PyTorch ops of flush and refill and a host sync for
// the loop condition, with the card idle in between.  So:
//
// - one cooperative launch a chunk (all blocks co-resident, checked by the
//   launch); between rounds two grid syncs: after the first every lane
//   knows how many lanes of earlier blocks flushed, so its refill id is
//   next_read + that count + its rank in its block, as the plain round
//   numbers refills in lane order; after the second every thread reads the
//   same loop condition (a lane live, or reads left below the last real
//   row + 1).  No host sync between rounds;
// - the lane's FqLane record stays in registers across rounds;
// - its bucket heads in shared memory, interleaved over the block's
//   threads as in search.cu; its pool and free stack a slab per lane in
//   global memory;
// - hit rows go straight to the read's rows of the zeroed output, and a
//   flush writes only the read's n_aln, fallback bits and steps.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "search_body.cuh"

namespace cg = cooperative_groups;

// dynamic shared memory of a block: the bucket heads of each lane
static const size_t kScanSmem =
    (size_t)FQ_SCAN_THREADS * sizeof(int16_t) * FQ_NBUCK;

// Whether `flag` holds for any thread of the grid.  Block g writes its OR
// to live[g]; live is rewritten only after the next grid sync, which every
// block reaches after reading it.
__device__ bool fq_grid_any(cg::grid_group& grid, int* live, bool flag) {
  const int any = __syncthreads_or(flag);
  if (threadIdx.x == 0) live[blockIdx.x] = any;
  grid.sync();
  int r = 0;
  for (int g = 0; g < (int)gridDim.x; ++g) r |= __ldcg(live + g);
  return r != 0;
}

// The rank of this thread's `flag` among the grid's flags in thread order
// (the count of set flags before it) and their total.  Block g writes its
// count to cnt[g], rewritten only after the next grid sync.
__device__ void fq_grid_rank(cg::grid_group& grid, int* cnt, int* warp_n,
                             bool flag, int& rank, int& total) {
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const unsigned bal = __ballot_sync(0xFFFFFFFFu, flag);
  if (lane == 0) warp_n[wid] = __popc(bal);
  __syncthreads();
  int before = __popc(bal & ((1u << lane) - 1u)), in_block = 0;
  for (int u = 0; u < FQ_SCAN_THREADS / 32; ++u) {
    before += u < wid ? warp_n[u] : 0;
    in_block += warp_n[u];
  }
  if (t == 0) cnt[blockIdx.x] = in_block;
  grid.sync();
  total = 0;
  for (int g = 0; g < (int)gridDim.x; ++g) {
    const int v = __ldcg(cnt + g);
    before += g < (int)blockIdx.x ? v : 0;
    total += v;
  }
  rank = before;
}

__global__ void __launch_bounds__(FQ_SCAN_THREADS)
    fq_scan_kernel(FmView fm, SearchParams P, FqChunk ck, FqSlot* pool,
                   uint16_t* freel, FqOut out, int B, int k_inner,
                   int n_ids, int* cnt, int* live,
                   unsigned long long* stats) {
  extern __shared__ int16_t fq_heads[];
  __shared__ int warp_n[FQ_SCAN_THREADS / 32];
  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x;
  const int b = blockIdx.x * FQ_SCAN_THREADS + t;
  const bool lane = b < B;
  const FqWork w = {pool + (int64_t)b * P.NP, freel + (int64_t)b * P.NP,
                    fq_heads + t, nullptr, FQ_SCAN_THREADS};
  FqLane s;
  s.rid = -1;
  s.done = 1;
  if (lane) fq_scan_refill(s, ck, b);  // lanes start on reads 0..B-1
  int next_read = B, rounds = 0;
  unsigned long long busy = 0;
  bool go = fq_grid_any(grid, live, lane && !s.done) || next_read < n_ids;
  while (go) {
    if (lane) fq_scan_advance(s, fm, P, ck, w, out, k_inner);
    const bool flush = lane && fq_scan_flush(s, out);
    if (flush) busy += s.steps;
    int rank, total;
    fq_grid_rank(grid, cnt, warp_n, flush, rank, total);
    if (flush) fq_scan_refill(s, ck, next_read + rank);
    next_read += total;
    ++rounds;
    go = fq_grid_any(grid, live, lane && !s.done) || next_read < n_ids;
  }
  if (busy) atomicAdd(stats + 1, busy);
  if (b == 0) stats[0] = rounds;
}

// Lanes that fit the card co-resident (a cooperative launch's limit), or
// a negative CUDA error.
extern "C" int fq_scan_max_lanes() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fq_scan_kernel, FQ_SCAN_THREADS, kScanSmem);
  if (e != cudaSuccess) return -(int)e;
  return per_sm * sms * FQ_SCAN_THREADS;
}

// Chunk inputs as for fq_search_launch (N reads; widths updated in place).
// pool: (B, NP) slots of 4 int32; freel: (B, NP) uint16; outputs alns
// (N, 48, 3), n_aln / fb / steps (N,), all zeroed; n_ids: the last real
// row + 1; sync: 2 * B int32 of scratch; stats: 2 uint64, zeroed, that
// receive [rounds, busy steps].  B must not exceed fq_scan_max_lanes().
extern "C" int fq_scan_launch(
    const int32_t* tab, const int32_t* fm_hp, const int32_t* sp,
    const uint8_t* seqs, const int32_t* lens, const int32_t* md,
    const int32_t* use_seed, const int32_t* n_n, int N, int32_t* widths,
    const int32_t* seed_w, void* pool, void* freel, int32_t* alns,
    int32_t* n_aln, int32_t* fb, int32_t* steps, int B, int k_inner,
    int n_ids, int32_t* sync, void* stats, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  FmView fm = fm_view(tab, fm_hp);
  SearchParams P = search_params(sp);
  FqChunk ck = {seqs, lens, md, use_seed, n_n, N, widths, seed_w};
  FqOut out = {alns, n_aln, fb, steps, nullptr};
  FqSlot* pool_ = (FqSlot*)pool;
  uint16_t* freel_ = (uint16_t*)freel;
  int* cnt = sync;
  int* live = sync + B;
  unsigned long long* stats_ = (unsigned long long*)stats;
  void* args[] = {&fm, &P, &ck, &pool_, &freel_, &out, &B, &k_inner,
                  &n_ids, &cnt, &live, &stats_};
  const int blocks = (B + FQ_SCAN_THREADS - 1) / FQ_SCAN_THREADS;
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)fq_scan_kernel, dim3(blocks), dim3(FQ_SCAN_THREADS), args,
      kScanSmem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
