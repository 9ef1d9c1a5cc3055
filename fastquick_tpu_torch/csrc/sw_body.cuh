// Forward pass of the local Smith-Waterman of aln_local_core
// (libbwa/stdaln.c:529-745) for one (ref, query) job: best score and its
// 1-based end cell, with the C code's freeze-F rule (stdaln.c:278-284: the
// running horizontal gap F is only updated and applied past a cell whose
// left neighbour is positive) and the strict-greater first-max tie rule.
#pragma once

#include "fq_common.cuh"

#define FQ_SW_MATCH 11
#define FQ_SW_MISMATCH (-19)
#define FQ_SW_VS_N (-13)
#define FQ_SW_GAP_EXT 9
#define FQ_SW_QR (26 + 9)  // gap open + extend

// Element x of a row lives at [x * stride] (stride = batch size in the
// kernel's interleaved layout).  h/e: scratch rows of rl entries.
// out: [best, end_i (ref), end_j (query), 0].
FQ_HD void sw_forward_job(const uint8_t* ref, const uint8_t* query,
                          int64_t stride, int rl, int ql, int32_t* h,
                          int32_t* e, int32_t out[4]) {
  for (int j = 0; j < rl; ++j) {
    h[j * stride] = 0;
    e[j * stride] = 0;
  }
  int best = 0, bi = 0, bj = 0;
  for (int i = 0; i < ql; ++i) {
    const int qc = query[i * stride];
    int diag = 0, hleft = 0, f = 0;
    for (int j = 0; j < rl; ++j) {
      const int rc = ref[j * stride];
      const int m = (qc == 4 || rc == 4) ? FQ_SW_VS_N
                    : (qc == rc ? FQ_SW_MATCH : FQ_SW_MISMATCH);
      const int hp = h[j * stride];
      const int ep = e[j * stride];
      int hv = fq_max(diag + m, 0);
      if (hleft > 0) {  // freeze-F
        f = fq_max(f - FQ_SW_GAP_EXT, hleft - FQ_SW_QR);
        hv = fq_max(hv, f);
      }
      const int en = fq_max(fq_max(ep - FQ_SW_GAP_EXT, hp - FQ_SW_QR), 0);
      hv = fq_max(hv, en);
      h[j * stride] = hv;
      e[j * stride] = en;
      diag = hp;
      hleft = hv;
      if (hv > best) {
        best = hv;
        bi = j + 1;
        bj = i + 1;
      }
    }
  }
  out[0] = best;
  out[1] = bi;
  out[2] = bj;
  out[3] = 0;
}
