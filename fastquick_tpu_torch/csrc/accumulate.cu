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
// What bounds it on this card: bytes.  A covered base reads its code, its
// quality and two or three table words (~20 bytes in the one-program
// step's int32 planes); the sums are 32-bit adds.  What stands in the way
// is contention: ~30 M adds at 200,000 x 150 fall into 256 bins four times
// over.  So:
// - fq_accum_dense (dense3, the four histograms, n_base_mapped): a grid-
//   stride loop over the flat (B, L) grid, warp-uniform so that the warp
//   intrinsics see every lane.  The histograms live in shared memory, a
//   copy a block, and each block adds its nonzero bins to the output
//   once.  The quality bins, which the bases of a warp share (a read's
//   qualities take few values), are aggregated across the warp first
//   (__match_any_sync: one shared add a value).  dense3 takes global
//   atomics: a warp's bases fall on consecutive sites, so there is little
//   to aggregate.  A second small kernel turns dense3's tiers into depth,
//   q20 and q30.
// - fq_accum_pileup (pileup, pileup_cnt, pileup_ovf): a marker's entries
//   must sit in read order, and atomics arrive in any order.  Four steps:
//   count each marker's entries (atomics, order-free), an exclusive scan
//   of the counts (one block), each entry's flat index b * L + j into its
//   marker's bucket (atomics, any order), then a warp a marker puts its
//   bucket in order: up to 32 entries by ranking each lane's index against
//   the others through shuffles, more by extracting the next smallest
//   index once a kept slot (the pileup cap bounds the rounds).  A kept
//   entry's packed word is made from its index again by the body.  The
//   flat index orders a marker's entries exactly as the plain version's
//   stable sort over the flattened grid does.
#include <climits>

#include <cuda_runtime.h>

#include "accumulate_body.cuh"

#define FQ_ACC_THREADS 256
#define FQ_ACC_BLOCKS_PER_SM 8
#define FQ_FULL 0xffffffffu

static int fq_acc_grid(long long items) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (items + FQ_ACC_THREADS - 1) / FQ_ACC_THREADS;
  const long long most = (long long)sms * FQ_ACC_BLOCKS_PER_SM;
  return (int)(want < most ? want : most);
}

__global__ void __launch_bounds__(FQ_ACC_THREADS)
    fq_accum_dense_kernel(const FqAccIn a, int32_t* dense3, int32_t* out) {
  __shared__ int32_t h[4 * 256];
  __shared__ int32_t n_reg;
  for (int k = threadIdx.x; k < 4 * 256; k += blockDim.x) h[k] = 0;
  if (threadIdx.x == 0) n_reg = 0;
  __syncthreads();
  const int total = a.B * a.L;
  const int stride = gridDim.x * blockDim.x;
  int mine = 0;
  // the loop's trip count is the block's, so every lane reaches the
  // warp intrinsics
  for (int base = blockIdx.x * blockDim.x; base < total; base += stride) {
    const int i = base + threadIdx.x;
    int qkey = -1;  // bq << 1 | mism of a base in a region, else -1
    if (i < total) {
      const int b = i / a.L, j = i - b * a.L;
      FqAccBase o;
      if (fq_acc_locate(a, b, j, o)) {
        fq_acc_read(a, b, j, o);
        const int mism = fq_acc_mism(a, o);
        atomicAdd(&dense3[o.site + fq_acc_tier(o.bq) * (a.S + 1)], 1);
        const int cb = fq_acc_cycle_bin(o.cycle);
        atomicAdd(&h[2 * 256 + cb], 1);
        if (mism) atomicAdd(&h[3 * 256 + cb], 1);
        qkey = o.bq << 1 | mism;
        ++mine;
      }
    }
    const unsigned grp = __match_any_sync(FQ_FULL, qkey);
    if (qkey >= 0 && (int)(threadIdx.x & 31) == __ffs(grp) - 1) {
      const int c = __popc(grp);
      atomicAdd(&h[qkey >> 1], c);
      if (qkey & 1) atomicAdd(&h[256 + (qkey >> 1)], c);
    }
  }
  mine = __reduce_add_sync(FQ_FULL, mine);
  if ((threadIdx.x & 31) == 0 && mine) atomicAdd(&n_reg, mine);
  __syncthreads();
  int32_t* hist = out + fq_acc_hist_at(a.S, 0);
  for (int k = threadIdx.x; k < 4 * 256; k += blockDim.x)
    if (h[k]) atomicAdd(&hist[k], h[k]);
  if (threadIdx.x == 0 && n_reg) atomicAdd(&hist[4 * 256], n_reg);
}

__global__ void __launch_bounds__(FQ_ACC_THREADS)
    fq_accum_finish_kernel(const int32_t* dense3, int S, int32_t* out) {
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < S;
       s += gridDim.x * blockDim.x)
    fq_acc_finish_site(dense3, S, s, out);
}

// The dense statistics of a batch.  dense3: (3 (S + 1),) int32 scratch;
// out: (fq_acc_out_size(S),) int32 (device memory, as every input); both
// zeroed here.
extern "C" int fq_accum_dense_launch(FQ_ACC_IN_ARGS, int32_t* dense3,
                                     int32_t* out, void* stream) {
  const FqAccIn a = fq_acc_in(FQ_ACC_IN_NAMES);
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(
      dense3, 0, 3 * ((size_t)S + 1) * sizeof(int32_t), st);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(out, 0, fq_acc_out_size(S) * sizeof(int32_t), st);
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)B * L;
  if (total > 0)
    fq_accum_dense_kernel<<<fq_acc_grid(total), FQ_ACC_THREADS, 0, st>>>(
        a, dense3, out);
  if (S > 0)
    fq_accum_finish_kernel<<<fq_acc_grid(S), FQ_ACC_THREADS, 0, st>>>(
        dense3, S, out);
  return (int)cudaGetLastError();
}

// 1. each marker's entries
__global__ void __launch_bounds__(FQ_ACC_THREADS)
    fq_accum_count_kernel(const FqAccIn a, int32_t* cnt) {
  const int total = a.B * a.L;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int mk = fq_acc_marker(a, i);
    if (mk >= 0) atomicAdd(&cnt[mk], 1);
  }
}

// 2. off[m] = the entries of markers before m (one block of 1,024)
__global__ void __launch_bounds__(1024)
    fq_accum_scan_kernel(const int32_t* cnt, int M, int32_t* off) {
  __shared__ int32_t warp_sum[32];
  __shared__ int32_t carry;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  if (t == 0) carry = 0;
  __syncthreads();
  for (int c = 0; c < M; c += 1024) {
    const int v = c + t < M ? cnt[c + t] : 0;
    int x = v;
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
    const int incl = carry + x + (w ? warp_sum[w - 1] : 0);
    if (c + t < M) off[c + t] = incl - v;
    __syncthreads();
    if (t == 1023) carry = incl;
    __syncthreads();
  }
  if (t == 0) off[M] = carry;
}

// 3. each entry's flat index into its marker's bucket; off[m] ends at the
// bucket's end
__global__ void __launch_bounds__(FQ_ACC_THREADS)
    fq_accum_fill_kernel(const FqAccIn a, int32_t* off, int32_t* bucket) {
  const int total = a.B * a.L;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int mk = fq_acc_marker(a, i);
    if (mk >= 0) bucket[atomicAdd(&off[mk], 1)] = i;
  }
}

// 4. a warp a marker: its kept entries in read order into its slots
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
  int last = -1;  // the index taken last round (indices are >= 0)
  for (int r = 0; r < kept; ++r) {
    unsigned lo = UINT_MAX;
    for (int t = lane; t < n; t += 32) {
      const int k = bk[t];
      if (k > last && (unsigned)k < lo) lo = (unsigned)k;
    }
    last = (int)__reduce_min_sync(FQ_FULL, lo);
    if (lane == 0 && base + r >= 0) row[r] = fq_acc_entry(a, last);
  }
}

// The marker pileups of a batch (FQ_ACC_READ; mapq given).  marker_base:
// (M,) slot offsets or null; pileup (M, cap), cnt (M,), ovf (1,) int32
// outputs and off (M + 1,), bucket (B L,) int32 scratch, all zeroed or
// filled here (device memory).
extern "C" int fq_accum_pileup_launch(FQ_ACC_IN_ARGS,
                                      const int32_t* marker_base, int M,
                                      int cap, int32_t* pileup, int32_t* cnt,
                                      int32_t* ovf, int32_t* off,
                                      int32_t* bucket, void* stream) {
  const FqAccIn a = fq_acc_in(FQ_ACC_IN_NAMES);
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(
      pileup, 0, (size_t)M * cap * sizeof(int32_t), st);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(cnt, 0, (size_t)M * sizeof(int32_t), st);
  if (e == cudaSuccess) e = cudaMemsetAsync(ovf, 0, sizeof(int32_t), st);
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)B * L;
  if (total <= 0 || M <= 0) return (int)cudaGetLastError();
  const int grid = fq_acc_grid(total);
  fq_accum_count_kernel<<<grid, FQ_ACC_THREADS, 0, st>>>(a, cnt);
  fq_accum_scan_kernel<<<1, 1024, 0, st>>>(cnt, M, off);
  fq_accum_fill_kernel<<<grid, FQ_ACC_THREADS, 0, st>>>(a, off, bucket);
  const int warps = FQ_ACC_THREADS / 32;
  fq_accum_select_kernel<<<(M + warps - 1) / warps, FQ_ACC_THREADS, 0,
                           st>>>(a, marker_base, M, cap, cnt, off, bucket,
                                 pileup, ovf);
  return (int)cudaGetLastError();
}
