// bwt_cal_width (libbwa/bwtaln.c:73-97) for one read-strand unit.
#pragma once

#include "fq_common.cuh"

// positions a unit walks between two calls of its accessor's load / store
#define FQ_WIDTH_TILE 32

// Walks the unit's L codes (0..4, 4 = N) and emits the raw per-position
// (w, bid) values (ops/fm.width_finalize adds the terminal entry).  Codes
// and outputs go through an accessor `io`, a tile of FQ_WIDTH_TILE
// positions at a time: io.load(p0, n) before positions [p0, p0 + n),
// io.code(i) and io.put(i, w, bid) for each position i, io.store(p0, n)
// after them.  The kernel's accessor stages the tile in shared memory
// (width.cu); the host build's reads and writes the unit's rows directly.
//
// A step needs occ(c) at k - 1 and at l.  Both positions are computed
// first; when they fall in the same Occ block, as they do once the
// interval has narrowed, the row is loaded once and counted twice,
// otherwise both rows are loaded as one batch.  L2 and the rows are held
// in registers (constant indices and selects only).
template <class Io>
FQ_HD void width_unit(const FmView& fm, int sel, int L, Io& io) {
  int l2[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) l2[c] = fm_L2(fm, sel, c);
  int k = 0, l = fm.n, bid = 0;
  for (int p0 = 0; p0 < L; p0 += FQ_WIDTH_TILE) {
    const int n = fq_min(L - p0, FQ_WIDTH_TILE);
    io.load(p0, n);
    for (int i = p0; i < p0 + n; ++i) {
      const int c = io.code(i);
      int nk = k, nl = l;
      if (c < 4) {
        const int pk = fm_pos(fm, sel, k - 1), pl = fm_pos(fm, sel, l);
        int32_t rk[12], rl[12];
        fm_row(fm, sel, pk >> 7, rk);
        if ((pl >> 7) == (pk >> 7)) {
#pragma unroll
          for (int j = 0; j < 12; ++j) rl[j] = rk[j];
        } else {
          fm_row(fm, sel, pl >> 7, rl);
        }
        const int L2c = fq_pick4(l2, c);
        nk = L2c + fm_count(rk, pk & 127, c) + 1;
        nl = L2c + fm_count(rl, pl & 127, c);
      }
      if (c >= 4 || nk > nl) {  // restart a new bucket
        ++bid;
        nk = 0;
        nl = fm.n;
      }
      k = nk;
      l = nl;
      io.put(i, l - k + 1, bid);
    }
    io.store(p0, n);
  }
}
