// Kernels 7 and 8: the per-base accumulation of a batch.
//
// Replaces the per-base accumulation of fastquick_tpu/ops/qc_full.py:623-
// 690 (inside qc_step_full: XLA scatter-adds into dense3 and four 256-bin
// histograms at :643-666, the marker pileups at :668-690 with
// _pileup_ranks at :227, a stable argsort and an associative_scan) and
// the jitted accum of fastquick_tpu/align/device_qc.py:69-98; no
// pallas_call.  The port's plain versions (ops/accumulate.py) run them as
// ~40 torch launches: index_add_ over the (B, L) grid, a stable sort and
// int64 intermediates.
//
// What bounds it on this card: bytes.  A covered base reads its site word;
// a base in a region its code, its quality, its text word and (one-program
// step) its marker word; the sums are 32-bit adds.  The JAX program
// gathers the grid once and derives the sums and the pileups from it; so
// does this one walk:
// - fq_accum_walk (counted as "accumulate"): a warp a read at a time, its
//   pos, len, strand and eligible flag loaded once, its bases 32 lanes at
//   a time along the read (coalesced, also in FQ_ACC_READ's stored
//   reversal), FQ_WALK_GROUP rounds staged so that their table reads are
//   in flight together.  Dense sums (when out is given): depth, q20 and q30
//   by global atomics straight into the output, which wrap mod 2^32 as the
//   plain version's int64 sums cast to int32 do; the four histograms in
//   shared memory, a copy a block, a warp's quality bins aggregated by
//   value first (__match_any_sync), each block's nonzero bins added to the
//   output once.  The grid is sized from the reads, up to
//   FQ_WALK_BLOCKS_PER_SM blocks an SM, so few blocks flush.  Pileup
//   entries (when counts is given): a base in a region on a marker appends
//   its flat index b * L + j to a compact list and counts its marker: one
//   vote a group of rounds after the sums, a ballot a round that has an
//   entry, the block's entries gathered in shared memory and placed in
//   the list by one global atomic a block (one counter for every append
//   serialised the walk).  Without dense sums (the standalone pileup) the
//   marker word is read first and the site word only at a marker.
// - fq_accum_order (counted as "pileup"): the list's entries in read order
//   into their markers' slots.  An exclusive scan of the marker counts (one
//   block), each entry's index into its marker's bucket (atomics, any
//   order), then a warp a marker puts its bucket in order: up to 32
//   entries by ranking each lane's index against the others through
//   shuffles, more by extracting the next smallest index once a kept slot
//   (the pileup cap bounds the rounds).  A kept entry's packed word is made
//   from its index again by the body, a lane a slot.  The flat index orders a marker's
//   entries exactly as the plain version's stable sort over the flattened
//   grid does.  Nothing here touches the (B, L) grid but the kept entries.
#include <climits>

#include <cuda_runtime.h>

#include "accumulate_body.cuh"

#define FQ_ACC_THREADS 256
#define FQ_WALK_WARPS 16  // a walk block's warps, a read each at a time
#define FQ_WALK_BLOCKS_PER_SM 2
#define FQ_WALK_GROUP 4  // rounds of 32 bases staged together
#define FQ_WALK_ENT_BUF 1024  // a walk block's entries kept in shared memory
#define FQ_SEL_REGS 8  // a select warp ranks up to 32 x 8 entries in registers
#define FQ_FULL 0xffffffffu

static int fq_acc_sms() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <bool D, bool E>
__global__ void __launch_bounds__(FQ_WALK_WARPS * 32, FQ_WALK_BLOCKS_PER_SM)
    fq_accum_walk_kernel(const FqAccIn a, int32_t* out, int32_t* ent,
                         int32_t* counts, int M) {
  __shared__ int32_t h[4 * 256];
  __shared__ int32_t n_reg;
  __shared__ int32_t sent[FQ_WALK_ENT_BUF];  // the block's entries
  // n_sent: slots taken; end_sent: the first slot of an append that did
  // not fit (it and those after it went to the list itself)
  __shared__ int32_t n_sent, end_sent, at_sent;
  if (D)
    for (int k = threadIdx.x; k < 4 * 256; k += blockDim.x) h[k] = 0;
  if (threadIdx.x == 0) {
    n_reg = n_sent = 0;
    end_sent = FQ_WALK_ENT_BUF;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  int32_t* const q20 = out + a.S;
  int32_t* const q30 = out + 2 * (int64_t)a.S;
  int mine = 0;
  // b and r.n are the warp's, so every lane reaches the warp intrinsics
  for (int b = blockIdx.x * FQ_WALK_WARPS + (threadIdx.x >> 5); b < a.B;
       b += gridDim.x * FQ_WALK_WARPS) {
    FqAccRow r;
    if (!fq_acc_row(a, b, r)) continue;
    for (int j0 = 0; j0 < r.n; j0 += 32 * FQ_WALK_GROUP) {
      FqAccBase o[FQ_WALK_GROUP];
      int mk[FQ_WALK_GROUP];
      bool in[FQ_WALK_GROUP];
      // stage 1: the table words that place each base
#pragma unroll
      for (int g = 0; g < FQ_WALK_GROUP; ++g) {
        const int j = j0 + 32 * g + lane;
        in[g] = false;
        mk[g] = -1;
        if (j >= r.n) continue;
        if (D) {
          in[g] = fq_acc_locate(a, r, j, o[g]);
        } else {  // the marker word first: few bases have one
          o[g].pac = fq_acc_pac(a, r, j);
          mk[g] = a.marker_id[o[g].pac];
          in[g] = mk[g] >= 0 && a.site_idx[o[g].pac] >= 0;
        }
      }
      // stage 2: what the bases in a region read
#pragma unroll
      for (int g = 0; g < FQ_WALK_GROUP; ++g) {
        if (!in[g]) continue;
        const int j = j0 + 32 * g + lane;
        if (D) {
          fq_acc_read(a, r, j, o[g]);
          if (E) mk[g] = a.marker_id[o[g].pac];
        }
      }
      // stage 3: the sums
#pragma unroll
      for (int g = 0; g < FQ_WALK_GROUP && D; ++g) {
        if (j0 + 32 * g >= r.n) break;  // the warp's
        int qkey = -1;  // bq << 1 | mism of a base in a region, else -1
        if (in[g]) {
          const int mism = fq_acc_mism(a, o[g]);
          const int tier = fq_acc_tier(o[g].bq), s = o[g].site;
          atomicAdd(out + s, 1);
          if (tier > 0) atomicAdd(q20 + s, 1);
          if (tier > 1) atomicAdd(q30 + s, 1);
          const int cb = fq_acc_cycle_bin(o[g].cycle);
          atomicAdd(&h[2 * 256 + cb], 1);
          if (mism) atomicAdd(&h[3 * 256 + cb], 1);
          qkey = o[g].bq << 1 | mism;
          ++mine;
        }
        const unsigned grp = __match_any_sync(FQ_FULL, qkey);
        if (qkey >= 0 && lane == __ffs(grp) - 1) {
          const int c = __popc(grp);
          atomicAdd(&h[qkey >> 1], c);
          if (qkey & 1) atomicAdd(&h[256 + (qkey >> 1)], c);
        }
      }
      // stage 4: the entries, few: one vote a group, after the sums (the
      // marker words arrive meanwhile), then a ballot a round
      if (!E) continue;
      unsigned bits = 0;  // bit g: round g's base is an entry
#pragma unroll
      for (int g = 0; g < FQ_WALK_GROUP; ++g)
        bits |= (unsigned)(in[g] && mk[g] >= 0) << g;
      if (!__any_sync(FQ_FULL, bits)) continue;
#pragma unroll
      for (int g = 0; g < FQ_WALK_GROUP; ++g) {
        const bool entry = bits >> g & 1;
        const unsigned bal = __ballot_sync(FQ_FULL, entry);
        if (!bal) continue;
        // into the block's buffer, or, when it is full, the list itself
        int at = 0;
        if (lane == 0) {
          at = atomicAdd(&n_sent, __popc(bal));
          if (at + __popc(bal) > FQ_WALK_ENT_BUF) {
            atomicMin(&end_sent, at);
            at = FQ_WALK_ENT_BUF +
                 atomicAdd(&counts[FQ_ACC_N_ENT(M)], __popc(bal));
          }
        }
        at = __shfl_sync(FQ_FULL, at, 0);
        if (entry) {
          const int i = at + __popc(bal & ((1u << lane) - 1));
          const int idx = r.row + j0 + 32 * g + lane;
          if (i < FQ_WALK_ENT_BUF)
            sent[i] = idx;
          else
            ent[i - FQ_WALK_ENT_BUF] = idx;
          atomicAdd(&counts[mk[g]], 1);
        }
      }
    }
  }
  if (D) {
    mine = __reduce_add_sync(FQ_FULL, mine);
    if (lane == 0 && mine) atomicAdd(&n_reg, mine);
  }
  __syncthreads();
  if (E) {  // the buffer into the list, one global atomic a block
    const int n = n_sent < end_sent ? n_sent : end_sent;
    if (threadIdx.x == 0 && n)
      at_sent = atomicAdd(&counts[FQ_ACC_N_ENT(M)], n);
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += blockDim.x)
      ent[at_sent + k] = sent[k];
  }
  if (!D) return;
  int32_t* hist = out + fq_acc_hist_at(a.S, 0);
  for (int k = threadIdx.x; k < 4 * 256; k += blockDim.x)
    if (h[k]) atomicAdd(&hist[k], h[k]);
  if (threadIdx.x == 0 && n_reg) atomicAdd(&hist[4 * 256], n_reg);
}

// One walk of a batch's (B, L) grid (device memory, as every input).
// out: (fq_acc_out_size(S),) int32 dense sums, or null; zeroed here when
// zero_out, else added to (align --device_qc keeps its sums on the card
// across chunks).  counts: (M + 2,) int32, zeroed here, or null: no
// entries; else the entries go to ent, (B L,) int32, and counts holds
// each marker's entries, the entries appended (FQ_ACC_N_ENT) and the
// pileup's overflow (FQ_ACC_OVF, for fq_accum_order).
extern "C" int fq_accum_walk_launch(FQ_ACC_IN_ARGS, int32_t* out,
                                    int zero_out, int32_t* ent,
                                    int32_t* counts, int M, void* stream) {
  const FqAccIn a = fq_acc_in(FQ_ACC_IN_NAMES);
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
  if (out && zero_out)
    e = cudaMemsetAsync(out, 0, fq_acc_out_size(S) * sizeof(int32_t), st);
  if (counts && e == cudaSuccess)
    e = cudaMemsetAsync(counts, 0, ((size_t)M + 2) * sizeof(int32_t), st);
  if (e != cudaSuccess) return (int)e;
  if (B <= 0 || L <= 0 || (!out && !counts)) return (int)cudaGetLastError();
  const int want = (B + FQ_WALK_WARPS - 1) / FQ_WALK_WARPS;
  const int most = fq_acc_sms() * FQ_WALK_BLOCKS_PER_SM;
  const int grid = want < most ? want : most;
  const int threads = FQ_WALK_WARPS * 32;
  if (out && counts)
    fq_accum_walk_kernel<true, true><<<grid, threads, 0, st>>>(a, out, ent,
                                                               counts, M);
  else if (out)
    fq_accum_walk_kernel<true, false><<<grid, threads, 0, st>>>(a, out, ent,
                                                                counts, M);
  else
    fq_accum_walk_kernel<false, true><<<grid, threads, 0, st>>>(a, out, ent,
                                                                counts, M);
  return (int)cudaGetLastError();
}

// 1. off[m] = the entries of markers before m (one block of 1,024, a
// thread a run of consecutive markers)
__global__ void __launch_bounds__(1024)
    fq_accum_scan_kernel(const int32_t* cnt, int M, int32_t* off) {
  __shared__ int32_t warp_sum[32];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int per = (M + 1023) / 1024;
  const int lo = t * per < M ? t * per : M;
  const int hi = lo + per < M ? lo + per : M;
  int sum = 0;
  for (int k = lo; k < hi; ++k) sum += cnt[k];
  int x = sum;  // the inclusive scan of the runs' sums
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(FQ_FULL, x, d);
    if (lane >= d) x += u;
  }
  if (lane == 31) warp_sum[w] = x;
  __syncthreads();
  if (w == 0) {
    int y = warp_sum[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(FQ_FULL, y, d);
      if (lane >= d) y += u;
    }
    warp_sum[lane] = y;
  }
  __syncthreads();
  int run = x - sum + (w ? warp_sum[w - 1] : 0);
  for (int k = lo; k < hi; ++k) {
    off[k] = run;
    run += cnt[k];
  }
  if (t == 1023) off[M] = run;  // its run ends at M
}

// 2. each listed entry's flat index into its marker's bucket; off[m] ends
// at the bucket's end
__global__ void __launch_bounds__(FQ_ACC_THREADS)
    fq_accum_fill_kernel(const FqAccIn a, const int32_t* ent,
                         const int32_t* n_ent, int32_t* off,
                         int32_t* bucket) {
  const int n = *n_ent;
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += gridDim.x * blockDim.x) {
    const int i = ent[t];
    bucket[atomicAdd(&off[fq_acc_entry_marker(a, i)], 1)] = i;
  }
}

// 3. a warp a marker: its kept entries in read order into its slots
__global__ void __launch_bounds__(FQ_ACC_THREADS)
    fq_accum_select_kernel(const FqAccIn a, const int32_t* marker_base,
                           int M, int cap, const int32_t* cnt,
                           const int32_t* end, const int32_t* bucket,
                           int32_t* pileup, int32_t* ovf) {
  const int lane = threadIdx.x & 31;
  const int m = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (m >= M) return;  // the whole warp
  const int n = cnt[m], base = marker_base ? marker_base[m] : 0;
  const int kept = fq_acc_kept(n, base, cap);
  const int32_t* bk = bucket + (end[m] - n);
  int32_t* row = pileup + (int64_t)m * cap + base;
  if (lane == 0 && n > kept) atomicAdd(ovf, n - kept);
  if (!kept) return;
  if (n <= 32) {
    const int key = lane < n ? bk[lane] : INT_MAX;
    int rank = 0;
#pragma unroll
    for (int k = 0; k < 32; ++k) rank += __shfl_sync(FQ_FULL, key, k) < key;
    if (lane < n && rank < kept && base + rank >= 0)
      row[rank] = fq_acc_entry(a, key);
    return;
  }
  // the kept indices in order into their slots: the next smallest index
  // once a slot, from registers up to 32 FQ_SEL_REGS entries, else from
  // the bucket; then their packed words, a lane a slot, the entries'
  // table reads in flight together
  const bool regs = n <= 32 * FQ_SEL_REGS;
  int key[FQ_SEL_REGS];
#pragma unroll
  for (int q = 0; q < FQ_SEL_REGS; ++q)
    key[q] = regs && lane + 32 * q < n ? bk[lane + 32 * q] : INT_MAX;
  int last = -1;  // the index taken last round (indices are >= 0)
  for (int r = 0; r < kept; ++r) {
    int lo = INT_MAX;
    if (regs) {
#pragma unroll
      for (int q = 0; q < FQ_SEL_REGS; ++q)
        if (key[q] > last && key[q] < lo) lo = key[q];
    } else {
      for (int t = lane; t < n; t += 32) {
        const int k = bk[t];
        if (k > last && k < lo) lo = k;
      }
    }
    last = __reduce_min_sync(FQ_FULL, lo);
    if (lane == 0 && base + r >= 0) row[r] = last;
  }
  __syncwarp();
  for (int r = lane; r < kept; r += 32)
    if (base + r >= 0) row[r] = fq_acc_entry(a, row[r]);
}

// The marker pileups of a batch from fq_accum_walk's entry list (ent,
// counts as it left them; FQ_ACC_READ, mapq given).  marker_base: (M,)
// slot offsets or null; pileup (M, cap) int32 output, zeroed here; the
// overflow goes to counts[FQ_ACC_OVF(M)]; off (M + 1,) and bucket (B L,)
// int32 scratch (device memory).
extern "C" int fq_accum_order_launch(FQ_ACC_IN_ARGS,
                                     const int32_t* marker_base, int M,
                                     int cap, const int32_t* ent,
                                     int32_t* counts, int32_t* pileup,
                                     int32_t* off, int32_t* bucket,
                                     void* stream) {
  const FqAccIn a = fq_acc_in(FQ_ACC_IN_NAMES);
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = cudaMemsetAsync(
      pileup, 0, (size_t)M * cap * sizeof(int32_t), st);
  if (e != cudaSuccess) return (int)e;
  if (M <= 0) return (int)cudaGetLastError();
  fq_accum_scan_kernel<<<1, 1024, 0, st>>>(counts, M, off);
  fq_accum_fill_kernel<<<fq_acc_sms(), FQ_ACC_THREADS, 0, st>>>(
      a, ent, counts + FQ_ACC_N_ENT(M), off, bucket);
  const int warps = FQ_ACC_THREADS / 32;
  fq_accum_select_kernel<<<(M + warps - 1) / warps, FQ_ACC_THREADS, 0,
                           st>>>(a, marker_base, M, cap, counts, off, bucket,
                                 pileup, counts + FQ_ACC_OVF(M));
  return (int)cudaGetLastError();
}
