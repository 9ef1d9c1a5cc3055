// Kernel 4: K_INNER lockstep steps of the inexact search on B persistent
// lanes (the `FQ_BS_PALLAS=2` scan path).
//
// Replaces the Pallas v1 scan kernel _kernel (fastquick_tpu/ops/
// search_pallas.py:154, launched by _scan_call :612 for inner_scan_pallas
// :650).  The TPU kernel held the lanes' state as transposed (W, B) VMEM
// planes and advanced all B lanes K_INNER steps in lockstep with one-hot
// passes; the outer round (flush of finished lanes, refill with the next
// reads) ran in XLA between launches.  Here one thread runs one lane: it
// loads the lane's FqLane record, starts the lane's read if the outer round
// marked it fresh, takes up to K_INNER steps of the same search body as
// search.cu (search_body.cuh) and stores the record back.  Pool, free
// stack, bucket heads and hit rows live in per-lane global slabs
// (lanes x NP x 16 B: 8 MB at 1024 x 512): a read is suspended between
// launches, so unlike search.cu it keeps its bucket heads there too.
// Per-read inputs are read at the lane's read id from the
// chunk's tensors; gap_shadow updates the chunk's width rows in place,
// which gives the reference's values because a read lives in exactly one
// lane.  The outer round stays in PyTorch
// (ops/batch_search.scan_search).
//
// What bounds it: per step a chain of dependent L2-resident rank queries
// and pool accesses, as in search.cu, plus one 128-byte state round trip
// per lane and launch; 1,024 lanes fill only 8 blocks of 128 threads, and
// every round pays a launch and a host sync for the loop condition.
#include <cuda_runtime.h>

#include "search_body.cuh"

__global__ void fq_scan_kernel(FmView fm, SearchParams P, FqChunk ck,
                               FqLane* lanes, int B, FqSlot* pool,
                               uint16_t* freel, int16_t* heads,
                               int32_t* alns, int k_inner) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  fq_scan_lane(b, fm, P, ck, lanes, pool, freel, heads, alns, k_inner);
}

// Chunk inputs as for fq_search_launch (N reads; widths updated in place).
// lanes: (B, 32) int32 FqLane records; pool: (B, NP) slots of 4 int32;
// freel: (B, NP) uint16; heads: (B, 128) int16; alns: (B, 48, 3) int32.
extern "C" int fq_scan_launch(
    const int32_t* tab, const int32_t* fm_hp, const int32_t* sp,
    const uint8_t* seqs, const int32_t* lens, const int32_t* md,
    const int32_t* use_seed, const int32_t* n_n, int N, int32_t* widths,
    const int32_t* seed_w, void* lanes, int B, void* pool, void* freel,
    void* heads, int32_t* alns, int k_inner, void* stream) {
  if (B > 0) {
    const int threads = 128;
    const int blocks = (B + threads - 1) / threads;
    const FqChunk ck = {seqs, lens, md, use_seed, n_n, N, widths, seed_w};
    fq_scan_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        fm_view(tab, fm_hp), search_params(sp), ck, (FqLane*)lanes, B,
        (FqSlot*)pool, (uint16_t*)freel, (int16_t*)heads, alns, k_inner);
  }
  return (int)cudaGetLastError();
}
