// Kernel 6: bwape.c's pairing over a batch of read pairs, one launch.
//
// Replaces fastquick_tpu/ops/pe_device.py:221 pairing_sweep: the merge of
// each pair's occurrence entries in C's sort order (two stable argsorts
// there), the lax.scan over them (:391) and the result; no pallas_call.
// The port's plain version runs it as torch argsorts and gathers and a
// Python loop of ~80 torch operations an entry (ops/pe_device.
// pairing_sweep_plain).  Only the float32 penalty table stays outside:
// the wrapper builds it with the plain version's own torch operations.
//
// What bounds it on this card: a pair's sweep is a chain of dependent
// steps over its own entries, the pairs independent; the bytes are few (a
// pair's valid entries, the rows they name and the SE state: ~0.007 ms at
// 100,000 pairs), so the time is latency, hidden only by many warps in
// flight.  The design keeps no per-entry load after the sort (each
// entry's key carries its row's strand and score, csrc/pairing_body.cuh,
// all the sweep reads of the word), no shared memory in the main kernel,
// and the sweep one thread a pair with its state in registers:
// - k_occ <= 32 (2 K <= 64 entries, the first pass): a warp owns 32 pairs
//   and sorts them with its lanes, two keys a lane, through bitonic
//   networks, partners across lanes by __shfl_xor_sync.  A group of
//   consecutive pairs fills the 64 slots, each pair in a segment of the
//   group's largest span (the least power of two that holds a pair's
//   entries), so 32 production pairs of ~2 entries take one stage
//   together and a pair of 64 entries 21 stages alone.  A group's lanes
//   load its keys (coalesced along a pair's slots) and write them sorted
//   to a scratch laid out [entry][pair]; then each lane sweeps its own
//   pair, its reads coalesced across the warp.
// - larger K (k_occ2 512, at most ovf_cap pairs, the second pass): a
//   block a pair, the network over shared memory (8 KB at 1,024 entries),
//   then one thread sweeps.
#include <cuda_runtime.h>

#include "pairing_body.cuh"

#define FQ_PAIR_WARPS 4      // warps a block of the warp kernel
#define FQ_PAIR_BLOCK 256    // threads of the block kernel
#define FQ_FULL 0xffffffffu

// sk: the sorted keys, key t of pair p at sk[t * P + p] ((2 K, P) int64)
__global__ void __launch_bounds__(32 * FQ_PAIR_WARPS)
    fq_pairing_warp_kernel(const FqPairIn in, const FqPairOut o,
                           uint64_t* sk) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int base = (blockIdx.x * FQ_PAIR_WARPS + w) * 32;
  if (base >= in.P) return;  // the whole warp
  const int mine = base + lane;
  int c0 = 0, c1 = 0;
  if (mine < in.P) fq_pair_counts(in, mine, c0, c1);
  const int nn = c0 + c1, my_span = fq_pair_span(nn);
  // the networks, a group of pairs at a time: slot s (lane, lane + 32)
  // holds element s % M of the group's pair s / M; the next group's keys
  // are loaded before this group's network runs
  auto group = [&](int q, int& g, int& M, uint64_t kk[2], int64_t at[2]) {
    g = 1;
    M = __shfl_sync(FQ_FULL, my_span, q);
    while (q + g < 32 &&
           fq_pair_group_takes(g, M, __shfl_sync(FQ_FULL, my_span, q + g)))
      ++g;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int sl = lane + 32 * r, pq = q + sl / M, i = sl % M;
      const int n = __shfl_sync(FQ_FULL, nn, pq & 31);
      const int q0 = __shfl_sync(FQ_FULL, c0, pq & 31);
      const bool v = sl < g * M && i < n;
      kk[r] = v ? fq_pair_key(in, base + pq, i, q0, n) : FQ_PAIR_PAD;
      at[r] = v ? (int64_t)i * in.P + base + pq : -1;
    }
  };
  int g, M, g_next, M_next;
  uint64_t kk[2], kk_next[2];
  int64_t at[2], at_next[2];
  group(0, g_next, M_next, kk_next, at_next);
  for (int q = 0; q < 32; q += g) {
    g = g_next;
    M = M_next;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      kk[r] = kk_next[r];
      at[r] = at_next[r];
    }
    if (q + g < 32) group(q + g, g_next, M_next, kk_next, at_next);
    for (int k = 2; k <= M; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        if (j == 32) {  // M 64: the partner is the lane's other key
          const uint64_t a = kk[0];
          kk[0] = fq_pair_cx(kk[0], kk[1], lane, j, k);
          kk[1] = fq_pair_cx(kk[1], a, lane + 32, j, k);
          continue;
        }
        kk[0] = fq_pair_cx(kk[0], __shfl_xor_sync(FQ_FULL, kk[0], j),
                           lane & (M - 1), j, k);
        if (g * M > 32)
          kk[1] = fq_pair_cx(kk[1], __shfl_xor_sync(FQ_FULL, kk[1], j),
                             (lane + 32) & (M - 1), j, k);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (at[r] >= 0) sk[at[r]] = kk[r];
  }
  __syncwarp();  // the warp's scratch writes before its reads
  int chg = 0;
  if (mine < in.P) chg = fq_pair_sweep(in, mine, sk + mine, in.P, nn, o);
  chg = __reduce_add_sync(FQ_FULL, chg);
  if (lane == 0 && chg) atomicAdd(o.cnt, chg);
}

__global__ void __launch_bounds__(FQ_PAIR_BLOCK)
    fq_pairing_block_kernel(const FqPairIn in, const FqPairOut o) {
  extern __shared__ uint64_t s_key[];
  const int p = blockIdx.x, tid = threadIdx.x;
  int c0, c1;
  fq_pair_counts(in, p, c0, c1);
  const int n = c0 + c1, m = fq_pair_span(n);
  for (int i = tid; i < m; i += FQ_PAIR_BLOCK)
    s_key[i] = fq_pair_key(in, p, i, c0, n);
  __syncthreads();
  for (int k = 2; k <= m; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int c = tid; c < m / 2; c += FQ_PAIR_BLOCK) {
        // the c-th pair (i, i | j) of the stage: c with a 0 bit put in at j
        const int i = ((c & ~(j - 1)) << 1) | (c & (j - 1)), l = i | j;
        const uint64_t a = s_key[i], b = s_key[l];
        s_key[i] = fq_pair_cx(a, b, i, j, k);
        s_key[l] = fq_pair_cx(b, a, l, j, k);
      }
      __syncthreads();
    }
  }
  if (tid == 0) {
    const int chg = fq_pair_sweep(in, p, s_key, 1, n, o);
    if (chg) atomicAdd(o.cnt, chg);
  }
}

// out: (2, 7, P) int32; proper: (2, P) bool; cnt: (1,) int32, zeroed by the
// caller; scratch: (2 K, P) int64 where 2 K <= 64 (device memory, as
// every input).
extern "C" int fq_pairing_launch(FQ_PAIR_IN_ARGS, int32_t* out,
                                 uint8_t* proper, int32_t* cnt,
                                 int64_t* scratch, void* stream) {
  if (P <= 0) return 0;
  const FqPairIn in = fq_pair_in(FQ_PAIR_IN_NAMES);
  const FqPairOut o = {out, proper, cnt};
  const cudaStream_t s = (cudaStream_t)stream;
  if (2 * K <= FQ_PAIR_WARP_NK) {
    const int per_block = 32 * FQ_PAIR_WARPS;
    fq_pairing_warp_kernel<<<(P + per_block - 1) / per_block, per_block, 0,
                             s>>>(in, o, (uint64_t*)scratch);
  } else {
    const size_t bytes = (size_t)fq_pair_span(2 * K) * sizeof(uint64_t);
    if (bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          fq_pairing_block_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (e != cudaSuccess) return (int)e;
    }
    fq_pairing_block_kernel<<<P, FQ_PAIR_BLOCK, bytes, s>>>(in, o);
  }
  return (int)cudaGetLastError();
}
