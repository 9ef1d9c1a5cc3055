// bwt_cal_width (libbwa/bwtaln.c:73-97) for one read-strand unit.
#pragma once

#include "fq_common.cuh"

// codes[0..L): base codes 0..4 (4 = N); writes the raw per-position
// (w, bid) values (ops/fm.width_finalize adds the terminal entry).
FQ_HD void width_unit(const FmView& fm, int sel, const uint8_t* codes, int L,
                      int32_t* w_out, int32_t* bid_out) {
  int k = 0, l = fm.n, bid = 0;
  for (int i = 0; i < L; ++i) {
    const int c = codes[i];
    int nk = k, nl = l;
    if (c < 4) {
      const int L2c = fm.L2[sel][c];
      nk = L2c + fm_occ1(fm, sel, k - 1, c) + 1;
      nl = L2c + fm_occ1(fm, sel, l, c);
    }
    if (c >= 4 || nk > nl) {  // restart a new bucket
      ++bid;
      nk = 0;
      nl = fm.n;
    }
    k = nk;
    l = nl;
    w_out[i] = l - k + 1;
    bid_out[i] = bid;
  }
}
