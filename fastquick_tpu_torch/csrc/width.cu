// Kernel 1: bwt_cal_width for every read-strand and seed unit.
//
// Replaces the Pallas _width_kernel (fastquick_tpu/ops/search_pallas.py:1603,
// driven by width_pallas :1711), which walked 2048-lane batches over an FM
// table packed for TPU VMEM.  Here one thread owns one unit and keeps
// (k, l, bid) in registers for its L sequential backward_ext steps; each
// step makes two occ reads of one 64-byte table row.  The production
// panel's table (~6.5 MB for both strands) stays in the 50 MB L2, so the
// kernel is bound by the latency of that dependent chain of L2 reads, not
// by device-memory bytes: many units in flight hide it.
#include <cuda_runtime.h>

#include "width_body.cuh"

__global__ void fq_width_kernel(FmView fm, const uint8_t* __restrict__ units,
                                const int32_t* __restrict__ sel, int M, int L,
                                int32_t* __restrict__ w_out,
                                int32_t* __restrict__ bid_out) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const int64_t off = (int64_t)m * L;
  width_unit(fm, sel[m], units + off, L, w_out + off, bid_out + off);
}

// units: (M, L) uint8 codes; sel: (M,) strand selector; w/bid: (M, L).
// fm_hp: host array DeviceFM.host_params().  Returns cudaGetLastError().
extern "C" int fq_width_launch(const int32_t* tab, const int32_t* fm_hp,
                               const uint8_t* units, const int32_t* sel,
                               int M, int L, int32_t* w, int32_t* bid,
                               void* stream) {
  if (M > 0) {
    const int threads = 128;
    const int blocks = (M + threads - 1) / threads;
    fq_width_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        fm_view(tab, fm_hp), units, sel, M, L, w, bid);
  }
  return (int)cudaGetLastError();
}
