// Kernel 5: the drand48 reservoir draw of a batch of hit lists.
//
// Replaces fastquick_tpu/ops/drand48_device.py:167 aln2seq_draw_scan, a
// lax.scan over the reads with a while_loop over each read's best class
// and no pallas_call: the TPU has no int64 or float64, so it rode the
// 48-bit LCG on 12-bit limbs in int32 and reduced each double rounding to
// an exact integer test.  The card has both, so the draw computes what C
// computes: a uint64 LCG and one __dmul_rn a comparison or offset, built
// without --use_fast_math.
//
// What bounds it on this card: the stream is sequential, so every read's
// start state hangs on a chain of dependent operations through all the
// draws before it (the LCG's 64-bit multiply-add, the acceptance test),
// latency far below the card's rates; bytes are few.  So the design keeps
// that chain short (drand48_body.cuh): one block of FQ_DRAND_TILE threads
// walks the batch in tiles of as many reads.  In each tile
//   1. every thread classifies its read (best class nb, row 0) and a
//      block scan gives each read its serial and single ranks; the serial
//      reads' best-class rows go to shared memory (a tile ends early
//      where they would pass FQ_DRAND_ROWS), each serial read's thread
//      computes the affine jump over the single reads before it, and the
//      block bisects each staged row's acceptance threshold;
//   2. thread 0 walks the serial reads only: one jump (one 64-bit
//      multiply-add) across each run of single reads, then per row an LCG
//      step and an integer compare with the row's threshold, the next
//      read's shared-memory words loaded ahead.  It records each serial
//      read's start and end states and nothing else;
//   3. every serial read's thread draws its read again from its start
//      state, now with its selection (one double multiply); every single
//      read's thread jumps from the last serial read's end state (or the
//      tile's start) to its own start, by a table of the 2^k-step maps,
//      and draws;
//   4. a single read whose first draw is 0 took one draw, not two: the
//      first such read ends the tile there, and the next tile starts at
//      the read after it from state 0, so every read after it is drawn
//      again from the right state.
#include <cuda_runtime.h>

#include "drand48_body.cuh"

#define T FQ_DRAND_TILE
#define R FQ_DRAND_ROWS
#define SCAN_BITS 21
#define SCAN_MASK ((1ull << SCAN_BITS) - 1)

struct DrandTile {
  uint64_t ta[FQ_DRAND_JUMP_BITS], tc[FQ_DRAND_JUMP_BITS];  // 2^k steps
  uint64_t ja[T + 1], jc[T + 1];  // the jump before serial read j
  uint64_t pre[T], post[T];       // serial read j's start and end states
  uint64_t warp_sum[T / 32];
  int32_t f[T], k[T], w[T];  // row 0 of read t: packed word, k, width
  int32_t ser[T];   // tile index of serial read j
  int32_t sser[T];  // single reads before serial read j
  int32_t off[T + 1];  // serial read j's first row in rt/rw/rk/rf
  int32_t nbs[T + 1];  // serial read j's best class
  uint64_t rt[R];                    // staged rows: acceptance thresholds,
  int32_t rw[R], rk[R], rf[R], rc[R];  // widths, SA rows, words, cnt before
  uint64_t x0, xe;  // the tile's start and end states
  int base, n_t, n_ser, n_sgl, n_rows, brk;
};

// inclusive block scan of v (blockDim.x == T)
__device__ uint64_t block_scan(uint64_t v, DrandTile& s) {
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint64_t u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) s.warp_sum[wid] = v;
  __syncthreads();
  if (wid == 0) {
    uint64_t x = s.warp_sum[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint64_t u = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += u;
    }
    s.warp_sum[lane] = x;
  }
  __syncthreads();
  return wid ? v + s.warp_sum[wid - 1] : v;
}

__global__ void __launch_bounds__(T)
    fq_drand48_kernel(const int32_t* n_aln, const int32_t* alns, int N,
                      const int32_t* state_in, int32_t* f0, int32_t* row,
                      int32_t* state_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  DrandTile& s = *reinterpret_cast<DrandTile*>(smem);
  const int t = threadIdx.x;
  if (t == 0) {
    s.x0 = fq_drand_load(state_in);
    s.base = 0;
    s.brk = T;
  }
  if (t < FQ_DRAND_JUMP_BITS) fq_drand_power(1u << t, s.ta[t], s.tc[t]);
  __syncthreads();
  while (s.base < N) {
    const int base = s.base;
    const int r = base + t;
    // 1. classify, scan, stage the serial reads' rows
    int nb = 0, cls = FQ_DRAND_EMPTY;
    const int32_t* rows = alns + (int64_t)r * FQ_DRAND_A_MAX * 3;
    if (r < N) {
      // row 0 is loaded with n_aln, whatever n_aln is
      const int32_t f = rows[0], k = rows[1], w = rows[2] - rows[1] + 1;
      nb = fq_drand_best(rows, n_aln[r]);
      s.f[t] = f;
      s.k[t] = k;
      s.w[t] = w;
      cls = fq_drand_class(nb, w);
    }
    const uint64_t v =
        (cls == FQ_DRAND_SERIAL ? (uint64_t)nb : 0) |
        ((uint64_t)(cls == FQ_DRAND_SERIAL) << SCAN_BITS) |
        ((uint64_t)(cls == FQ_DRAND_SINGLE) << (2 * SCAN_BITS));
    const uint64_t incl = block_scan(v, s);
    const uint64_t excl = incl - v;
    const int n_t = __syncthreads_count(r < N && (incl & SCAN_MASK) <= R);
    if (t == n_t - 1) {
      s.n_t = n_t;
      s.n_rows = (int)(incl & SCAN_MASK);
      s.n_ser = (int)((incl >> SCAN_BITS) & SCAN_MASK);
      s.n_sgl = (int)(incl >> (2 * SCAN_BITS));
    }
    const bool in_tile = t < n_t;
    const int seg = (int)((excl >> SCAN_BITS) & SCAN_MASK);
    const int sgl = (int)(excl >> (2 * SCAN_BITS));
    if (in_tile && cls == FQ_DRAND_SERIAL) {
      const int o = (int)(excl & SCAN_MASK);
      s.ser[seg] = t;
      s.sser[seg] = sgl;
      s.off[seg] = o;
      s.nbs[seg] = nb;
      int32_t cnt = 0;
#pragma unroll 4
      for (int i = 0; i < nb; ++i) {
        const int32_t w = rows[3 * i + 2] - rows[3 * i + 1] + 1;
        s.rf[o + i] = rows[3 * i];
        s.rk[o + i] = rows[3 * i + 1];
        s.rw[o + i] = w;
        s.rc[o + i] = cnt;
        cnt += w;
      }
    }
    __syncthreads();
    if (in_tile && cls == FQ_DRAND_SERIAL) {
      const int gap = sgl - (seg ? s.sser[seg - 1] : 0);
      fq_drand_power(2u * gap, s.ja[seg], s.jc[seg]);
    }
    for (int q = t; q < s.n_rows; q += T)
      s.rt[q] = fq_drand_threshold(s.rw[q], s.rc[q]);
    __syncthreads();
    // 2. the serial walk (index j + 1 past the last read is not used)
    if (t == 0) {
      uint64_t x = s.x0, a = s.ja[0], c = s.jc[0];
      int o = s.off[0], nbj = s.nbs[0];
      const int n_ser = s.n_ser;
      for (int j = 0; j < n_ser; ++j) {
        const uint64_t an = s.ja[j + 1], cn = s.jc[j + 1];
        const int on = s.off[j + 1], nbn = s.nbs[j + 1];
        x = fq_drand_apply(a, c, x);
        s.pre[j] = x;
        x = fq_drand_chain(x, nbj, s.rt + o);
        s.post[j] = x;
        a = an;
        c = cn;
        o = on;
        nbj = nbn;
      }
      s.xe = fq_drand_jump(
          s.ta, s.tc, 2u * (s.n_sgl - (n_ser ? s.sser[n_ser - 1] : 0)), x);
    }
    __syncthreads();
    // 3. each read from its own start state
    if (in_tile && cls == FQ_DRAND_SERIAL) {
      uint64_t x = s.pre[seg];
      const int o = s.off[seg];
      fq_drand_walk(x, nb, s.rt + o, s.rk + o, s.rw + o, s.rf + o, f0[r],
                    row[r]);
    } else if (in_tile && cls == FQ_DRAND_SINGLE) {
      const uint64_t x =
          fq_drand_jump(s.ta, s.tc, 2u * (sgl - (seg ? s.sser[seg - 1] : 0)),
                        seg ? s.post[seg - 1] : s.x0);
      int32_t fo, ro;
      if (fq_drand_single(x, s.f[t], s.k[t], s.w[t], fo, ro)) {
        f0[r] = fo;
        row[r] = ro;
      } else {
        atomicMin(&s.brk, t);
      }
    } else if (in_tile && cls == FQ_DRAND_EMPTY) {
      f0[r] = 0;
      row[r] = 0;
    }
    __syncthreads();
    // 4. the next tile: after the tile, or after its first broken read
    if (t == 0) {
      if (s.brk < s.n_t) {
        f0[base + s.brk] = 0;
        row[base + s.brk] = 0;
        s.x0 = 0;
        s.base = base + s.brk + 1;
      } else {
        s.x0 = s.xe;
        s.base = base + s.n_t;
      }
      s.brk = T;
    }
    __syncthreads();
  }
  if (t == 0) fq_drand_store(s.x0, state_out);
}

// n_aln: (N,) int32; alns: (N, 48, 3) int32 hit rows; state_in/state_out:
// (4,) int32 12-bit limbs (device memory); outputs f0/row: (N,) int32.
extern "C" int fq_drand48_launch(const int32_t* n_aln, const int32_t* alns,
                                 int N, const int32_t* state_in, int32_t* f0,
                                 int32_t* row, int32_t* state_out,
                                 void* stream) {
  const int bytes = (int)sizeof(DrandTile);
  cudaError_t e = cudaFuncSetAttribute(
      fq_drand48_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  fq_drand48_kernel<<<1, T, bytes, (cudaStream_t)stream>>>(
      n_aln, alns, N, state_in, f0, row, state_out);
  return (int)cudaGetLastError();
}
