// Kernel 1: bwt_cal_width for every read-strand and seed unit.
//
// Replaces the Pallas _width_kernel (fastquick_tpu/ops/search_pallas.py:1603,
// driven by width_pallas :1711), which walked 2048-lane batches over an FM
// table packed for TPU VMEM.  Here one thread owns one unit and keeps
// (k, l, bid), the unit's four L2 values and the step's FM rows in
// registers for its L sequential backward_ext steps.
//
// What bounds it on this card: each step waits on one or two 64-byte
// table rows (the ~6.5 MB table of the production panel stays in the 50
// MB L2), so a unit is a chain of L dependent L2 loads plus two rank
// counts; bytes and operations are far below the card's rates.  65,536
// units fit the card in one wave, and on the card half as many units
// take about 85% of the time (~1.6 us a step of 160), so the chain's
// length, not the number of loads, sets it; variants that loaded less
// were slower (PERF.md).  The design keeps the chain short and the
// memory system free for it:
//
// - no local memory: L2 and the Occ checkpoint are picked by selects and
//   the rank count is fully unrolled with branch-free masks (ptxas shows
//   the stack frame);
// - one row a step where k - 1 and l share an Occ block, as they do once
//   the interval has narrowed; two independent loads otherwise;
// - codes and outputs move through shared memory a tile of 32 positions
//   at a time: a block stages its 128 units' codes with loads a warp of
//   which reads 32 consecutive bytes of one unit, and writes each tile of
//   (w, bid) back with stores a warp of which writes 128 consecutive bytes,
//   in place of one scattered access per thread and position.
#include <cuda_runtime.h>

#include "width_body.cuh"

#define FQ_WIDTH_THREADS 128
// bytes between two staged positions: the stores of a warp (one unit, 32
// positions) then fall in distinct banks
#define FQ_WIDTH_CSTRIDE (FQ_WIDTH_THREADS + 4)
// int32 between two units' output rows, for the same reason
#define FQ_WIDTH_OSTRIDE (FQ_WIDTH_TILE + 1)

// width_unit's accessor in the kernel: the block's tiles in shared memory.
// Thread t owns unit m0 + t; threads past M walk all-N codes so that every
// thread reaches the block's barriers, and their outputs are not stored.
// Its methods are host-device like width_unit, which calls them; only the
// device pass ever runs them.
struct WidthTiles {
  uint8_t* cs;           // [position][thread] codes of the tile
  int32_t *ws, *bs;      // [thread][position] outputs of the tile
  const uint8_t* units;  // (M, L)
  int32_t *w_out, *bid_out;
  int m0, M, L, t, p0;

  FQ_HD void load(int p0_, int n) {
    p0 = p0_;
    const int lane = t & 31;
    for (int r = t >> 5; r < FQ_WIDTH_THREADS; r += FQ_WIDTH_THREADS / 32)
      if (lane < n)
        cs[lane * FQ_WIDTH_CSTRIDE + r] =
            m0 + r < M ? units[(int64_t)(m0 + r) * L + p0 + lane] : 4;
    fq_sync_block();
  }
  FQ_HD int code(int i) const {
    return cs[(i - p0) * FQ_WIDTH_CSTRIDE + t];
  }
  FQ_HD void put(int i, int w, int bid) {
    ws[t * FQ_WIDTH_OSTRIDE + i - p0] = w;
    bs[t * FQ_WIDTH_OSTRIDE + i - p0] = bid;
  }
  FQ_HD void store(int p0_, int n) {
    fq_sync_block();
    const int lane = t & 31;
    for (int r = t >> 5; r < FQ_WIDTH_THREADS; r += FQ_WIDTH_THREADS / 32)
      if (lane < n && m0 + r < M) {
        const int64_t off = (int64_t)(m0 + r) * L + p0_ + lane;
        w_out[off] = ws[r * FQ_WIDTH_OSTRIDE + lane];
        bid_out[off] = bs[r * FQ_WIDTH_OSTRIDE + lane];
      }
  }
};

__global__ void __launch_bounds__(FQ_WIDTH_THREADS)
    fq_width_kernel(FmView fm, const uint8_t* __restrict__ units,
                    const int32_t* __restrict__ sel, int M, int L,
                    int32_t* __restrict__ w_out,
                    int32_t* __restrict__ bid_out) {
  __shared__ uint8_t cs[FQ_WIDTH_TILE * FQ_WIDTH_CSTRIDE];
  __shared__ int32_t ws[FQ_WIDTH_THREADS * FQ_WIDTH_OSTRIDE];
  __shared__ int32_t bs[FQ_WIDTH_THREADS * FQ_WIDTH_OSTRIDE];
  const int t = threadIdx.x, m0 = blockIdx.x * FQ_WIDTH_THREADS;
  WidthTiles io = {cs, ws, bs, units, w_out, bid_out, m0, M, L, t, 0};
  width_unit(fm, m0 + t < M ? sel[m0 + t] : 0, L, io);
}

// units: (M, L) uint8 codes; sel: (M,) strand selector; w/bid: (M, L).
// fm_hp: host array DeviceFM.host_params().  Returns cudaGetLastError().
extern "C" int fq_width_launch(const int32_t* tab, const int32_t* fm_hp,
                               const uint8_t* units, const int32_t* sel,
                               int M, int L, int32_t* w, int32_t* bid,
                               void* stream) {
  if (M > 0 && L > 0) {
    const int blocks = (M + FQ_WIDTH_THREADS - 1) / FQ_WIDTH_THREADS;
    fq_width_kernel<<<blocks, FQ_WIDTH_THREADS, 0, (cudaStream_t)stream>>>(
        fm_view(tab, fm_hp), units, sel, M, L, w, bid);
  }
  return (int)cudaGetLastError();
}
