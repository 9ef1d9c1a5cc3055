// Forward pass of the local Smith-Waterman of aln_local_core
// (libbwa/stdaln.c:529-745) for one (ref, query) job: best score and its
// 1-based end cell, with the C code's freeze-F rule (stdaln.c:278-284: the
// running horizontal gap F is only updated and applied past a cell whose
// left neighbour is positive) and the strict-greater first-max tie rule in
// (query row i, ref column j) order.
//
// Evaluated as an anti-diagonal wavefront by one warp (sw.cu): the query
// rows are cut into strips of 32, lane t owns row 32 s + t of strip s and
// at step tau computes column j = tau - t, so the row above's cell at
// column j is lane t - 1's cell of the step before.  Lane 0 of strip s > 0
// reads it from a column buffer that lane 31 of strip s - 1 wrote.  The
// running gap F, the left neighbour and the diagonal are row-local, so
// each lane keeps them for its own row and freeze-F stays exact.
#pragma once

#include "fq_common.cuh"

#define FQ_SW_MATCH 11
#define FQ_SW_MISMATCH (-19)
#define FQ_SW_VS_N (-13)
#define FQ_SW_GAP_EXT 9
#define FQ_SW_QR (26 + 9)  // gap open + extend
#define FQ_SW_STRIP 32     // query rows of a strip: one per lane

// One lane's state: its row of the current strip, and its own first
// strict maximum over every cell it computed for the job.
struct SwLane {
  int qc;            // the row's query code
  int f, hleft;      // running horizontal gap; H of the cell to the left
  int diag;          // H of the row above one column to the left
  int h, e;          // H and vertical gap E of the lane's last cell
  int best, bi, bj;  // best score, its column j + 1 and row i + 1
};

FQ_HD void sw_lane_job(SwLane& L) { L.best = L.bi = L.bj = 0; }

FQ_HD void sw_lane_row(SwLane& L, int qc) {
  L.qc = qc;
  L.f = L.hleft = L.diag = L.h = L.e = 0;
}

// Cell (i, j) of the lane's row: rc is the ref code at column j, hp and ep
// the row above's H and E at column j (0 above the first row).
FQ_HD void sw_cell(SwLane& L, int i, int j, int rc, int hp, int ep) {
  const int m = (L.qc == 4 || rc == 4) ? FQ_SW_VS_N
                : (L.qc == rc ? FQ_SW_MATCH : FQ_SW_MISMATCH);
  int hv = fq_max(L.diag + m, 0);
  if (L.hleft > 0) {  // freeze-F
    L.f = fq_max(L.f - FQ_SW_GAP_EXT, L.hleft - FQ_SW_QR);
    hv = fq_max(hv, L.f);
  }
  const int en = fq_max(fq_max(ep - FQ_SW_GAP_EXT, hp - FQ_SW_QR), 0);
  hv = fq_max(hv, en);
  L.h = hv;
  L.e = en;
  L.diag = hp;
  L.hleft = hv;
  if (hv > L.best) {
    L.best = hv;
    L.bi = j + 1;
    L.bj = i + 1;
  }
}

// Whether maximum (best, bi, bj) comes before (best0, bi0, bj0): the higher
// score, then the earlier row, then the earlier column.
FQ_HD bool sw_before(int best, int bi, int bj, int best0, int bi0, int bj0) {
  return best > best0 ||
         (best == best0 && (bj < bj0 || (bj == bj0 && bi < bi0)));
}

// Steps of strip s of a job: columns 0..rl-1 of its rows, the last row
// starting rows - 1 steps after the first.
FQ_HD int sw_strip_steps(int rl, int ql, int s) {
  const int rows = fq_min(FQ_SW_STRIP, ql - FQ_SW_STRIP * s);
  return rl > 0 ? rl + rows - 1 : 0;
}

// Step tau of lane t in strip s of a job (ref codes ref[0..rl), ql query
// rows): up_h/up_e are lane t - 1's H and E after the previous step (what
// __shfl_up_sync gives), col the job's column buffer of 2 rl int32.  A
// lane whose row or column lies outside the job does nothing.
FQ_HD void sw_lane_step(SwLane& L, int t, int s, int tau, int rl, int ql,
                        const uint8_t* ref, int up_h, int up_e,
                        int32_t* col) {
  const int i = FQ_SW_STRIP * s + t, j = tau - t;
  if (i >= ql || j < 0 || j >= rl) return;
  int hp = up_h, ep = up_e;
  if (t == 0) {  // the row above is the previous strip's last
    hp = s > 0 ? col[2 * j] : 0;
    ep = s > 0 ? col[2 * j + 1] : 0;
  }
  sw_cell(L, i, j, ref[j], hp, ep);
  if (t == FQ_SW_STRIP - 1) {  // the row above the next strip's first
    col[2 * j] = L.h;
    col[2 * j + 1] = L.e;
  }
}
