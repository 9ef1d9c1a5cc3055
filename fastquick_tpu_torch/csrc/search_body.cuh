// Best-first inexact FM search of one read: bwt_match_gap
// (libbwa/bwtgap.c:104-264) with the step discipline of the reference
// package's lockstep search (fastquick_tpu/ops/batch_search.py
// _search_kernel), so every read gets exactly that path's result:
//
// - score-bucketed LIFO stacks (gap_stack_t): per-bucket heads plus an
//   intra-pool `next` link in the ai word; a 128-bit mask of non-empty
//   buckets finds the lowest one;
// - up to 9 children per expansion in C push order (insertion, deletions
//   c = 0..3, mismatches j = 1..4 with the exact-match child last);
// - the bwt_match_exact_alt walk in a chain register, one base per step;
// - top2 cutoffs, at most A_MAX recorded hits and gap_shadow on the hit
//   strand's width row;
// - the per-read step cap counted as the lockstep path counts it (a step
//   that ends the search is not counted) and the FB_* fallback-cause bits.
//
// Pool slot identity is internal (slots only thread the bucket lists), so
// slots come from a bump pointer plus a stack of recycled slots.
//
// The search is resumable: fq_lane_init sets a read up and fq_lane_step
// advances it by one step, with everything it carries between steps in an
// FqLane record plus the read's workspace.  search_read (search.cu) runs a
// read to the end; fq_scan_lane (scan.cu) suspends it every K_INNER steps.
#pragma once

#include "fq_common.cuh"

#define FQ_A_MAX 48
#define FQ_NBUCK 128
#define FQ_FB_POOL 1
#define FQ_FB_SCORE 2
#define FQ_FB_AMAX 4
#define FQ_FB_STEPCAP 8
#define FQ_STATE_M 0
#define FQ_STATE_I 1
#define FQ_STATE_D 2

// host array order of ops/search_kernels.SearchParams.to_array()
struct SearchParams {
  int L;   // padded read length: seq rows hold L codes, width rows L + 1
  int SL;  // seed length: seed width rows hold SL + 1 entries
  int NP;  // pool slots per read (< 32768: the next link is 15 bits)
  int step_cap, s_mm, s_gapo, s_gape, max_gapo, max_gape, indel_end_skip,
      max_del_occ, max_entries, max_top2, max_seed_diff;
};

FQ_HD SearchParams search_params(const int32_t* p) {
  SearchParams P;
  P.L = p[0]; P.SL = p[1]; P.NP = p[2]; P.step_cap = p[3];
  P.s_mm = p[4]; P.s_gapo = p[5]; P.s_gape = p[6]; P.max_gapo = p[7];
  P.max_gape = p[8]; P.indel_end_skip = p[9]; P.max_del_occ = p[10];
  P.max_entries = p[11]; P.max_top2 = p[12]; P.max_seed_diff = p[13];
  return P;
}

// one pool entry: ai = i | a << 13 | state << 14 | next << 16 (next = NP
// is the null link); d = mm | go << 6 | ge << 12 | ldp << 18
struct alignas(16) FqSlot {
  int32_t k, l, ai, d;
};

struct SearchOut {
  int n_aln, fb, steps;
};

// code of read strand `a` at position p (strand 1 is the complement)
FQ_HD int fq_seq_at(const uint8_t* seq0, int a, int p) {
  const int c = seq0[p];
  return (a == 0 || c > 3) ? c : 3 - c;
}

// bwtgap.c:81-91 on the [w, bid] pairs of one width row
FQ_HD void fq_gap_shadow(int32_t* wd, int ldp, int x, int n, int L) {
  const int end = fq_min(ldp, L + 1);
  int j = 0;
  for (int p = 0; p < end; ++p) {
    const int w = wd[2 * p];
    if (w > x) {
      wd[2 * p] = w - x;
    } else if (w == x) {
      ++j;
      wd[2 * p] = n - j;
      wd[2 * p + 1] = 1;
    }
  }
}

struct FqChildren {
  FqSlot c[9];
  int score[9];
  int n;
  bool bad_score;
};

FQ_HD void fq_child(FqChildren& ch, const SearchParams& P, int a, int i,
                    int k, int l, int mm, int go, int ge, int state,
                    int ldp) {
  const int sc = mm * P.s_mm + go * P.s_gapo + ge * P.s_gape;
  FqSlot& s = ch.c[ch.n];
  s.k = k;
  s.l = l;
  s.ai = (state << 14) | (a << 13) | i;
  s.d = mm | (go << 6) | (ge << 12) | (ldp << 18);
  ch.score[ch.n] = sc;
  ch.bad_score = ch.bad_score || sc >= FQ_NBUCK;
  ++ch.n;
}

// One read's inputs.  seq0: L reversed read codes (strand 0).  wid0/wid1:
// the strands' (L + 1) [w, bid] width rows, updated in place by
// gap_shadow.  sw0/sw1: the strands' (SL + 1) seed width rows.
struct FqRead {
  const uint8_t* seq0;
  int len, md, use_seed;
  int32_t *wid0, *wid1;
  const int32_t *sw0, *sw1;
};

// One read's workspace.  pool/freel: NP slots; heads: FQ_NBUCK entries;
// alns: FQ_A_MAX rows of [packed, k, l].
struct FqWork {
  FqSlot* pool;
  uint16_t* freel;
  int16_t* heads;
  int32_t* alns;
};

// Everything the search carries from one step to the next besides the
// workspace, so a read can be suspended after any step and resumed later
// (the scan kernel keeps one record per lane in global memory; the
// resident kernel keeps it in registers).  32 int32 words; the first six
// are ops/search_kernels.REC_*, which the outer round reads and writes.
struct alignas(16) FqLane {
  int32_t rid;       // the lane's read (-1: idle)
  int32_t done;      // the search ended (or the read is dead)
  int32_t fresh;     // set by the outer round: init the read first
  int32_t n_aln, overflow, steps;
  int32_t bump, ftop, n_entries;
  int32_t best_score, best_cnt, max_diff;
  int32_t ch_on;
  uint32_t bm[4];  // non-empty buckets
  int32_t ch[8];   // exact-walk chain register
  int32_t pad[7];
};
static_assert(sizeof(FqLane) == 128, "FqLane must stay 32 int32 words");

// The bucket bitmap is read and written through constant indices only, so
// a record held in a local variable can live in registers.
FQ_HD uint32_t fq_bm_word(const FqLane& s, int v) {
  return v == 0 ? s.bm[0] : v == 1 ? s.bm[1] : v == 2 ? s.bm[2] : s.bm[3];
}

FQ_HD void fq_bm_put(FqLane& s, int v, uint32_t x) {
  if (v == 0)
    s.bm[0] = x;
  else if (v == 1)
    s.bm[1] = x;
  else if (v == 2)
    s.bm[2] = x;
  else
    s.bm[3] = x;
}

// Set up one read's search (fresh_lane_state of the reference's lockstep
// path): slot 0 = (a=0, i=len, next=null), slot 1 = (a=1, i=len, next=0),
// bucket 0 -> slot 1.  md < 0 marks a padding row; dead reads (more Ns
// than md, or empty) are done at once with no work.  `rid` is left as is.
FQ_HD void fq_lane_init(FqLane& s, const SearchParams& P, int n,
                        const FqRead& r, int n_n, const FqWork& w) {
  s.fresh = 0;
  s.n_aln = 0;
  s.overflow = 0;
  s.steps = 0;
  s.ch_on = 0;
  s.ch[0] = s.ch[1] = s.ch[2] = s.ch[3] = 0;
  s.ch[4] = s.ch[5] = s.ch[6] = s.ch[7] = 0;
  s.done = (r.md < 0 || n_n > r.md || r.len <= 0) ? 1 : 0;
  if (s.done) return;
  const int NP = P.NP;
  w.pool[0].k = 0; w.pool[0].l = n; w.pool[0].ai = r.len | (NP << 16);
  w.pool[0].d = 0;
  w.pool[1].k = 0; w.pool[1].l = n; w.pool[1].ai = r.len | (1 << 13);
  w.pool[1].d = 0;
  w.heads[0] = 1;
  s.bm[0] = 1u; s.bm[1] = 0u; s.bm[2] = 0u; s.bm[3] = 0u;
  s.bump = 2;
  s.ftop = 0;
  s.n_entries = 2;
  s.best_score = (r.md + 1) * P.s_mm + (P.max_gapo + 1) * P.s_gapo +
                 (P.max_gape + 1) * P.s_gape;
  s.best_cnt = 0;
  s.max_diff = r.md;
}

// One step of a read that is not done: pop (or one chain base), hits,
// expansion.  A step that ends the search sets `done` and is not counted;
// the per-read step cap counts the others.
FQ_HD void fq_lane_step(FqLane& s, const FmView& fm, const SearchParams& P,
                        const FqRead& r, const FqWork& w) {
  const int n = fm.n, NP = P.NP, L = P.L, SL = P.SL;
  const int len = r.len;
  FqSlot* pool = w.pool;
  int16_t* heads = w.heads;
  int32_t* alns = w.alns;
  int* ch = s.ch;
  const bool work_chain = s.ch_on;
  int k = 0, l = 0, a = 0, i = 0, state = 0;
  int n_mm = 0, n_gapo = 0, n_gape = 0, ldp = 0, m = 0;
  int ww_i2 = 0, ww_i2m1 = 0, wb_i2 = 0, wb_i2m1 = 0;
  bool alive = false, done = false;
  if (!work_chain) {
    // empty stack, or C's `n_entries > max_entries` break
    if (s.n_entries == 0 || s.n_entries > P.max_entries) {
      s.done = 1;
      return;
    }
    const int bucket = s.bm[0]   ? fq_ctz(s.bm[0])
                       : s.bm[1] ? 32 + fq_ctz(s.bm[1])
                       : s.bm[2] ? 64 + fq_ctz(s.bm[2])
                       : s.bm[3] ? 96 + fq_ctz(s.bm[3])
                                 : -1;
    if (bucket < 0) {
      s.done = 1;
      return;
    }
    const int slot = heads[bucket];
    const FqSlot e = pool[slot];
    const int nxt = (e.ai >> 16) & 0x7FFF;
    if (nxt == NP)
      fq_bm_put(s, bucket >> 5,
                fq_bm_word(s, bucket >> 5) & ~(1u << (bucket & 31)));
    else
      heads[bucket] = (int16_t)nxt;
    w.freel[s.ftop++] = (uint16_t)slot;
    --s.n_entries;
    k = e.k;
    l = e.l;
    a = (e.ai >> 13) & 1;
    i = e.ai & 0x1FFF;
    state = (e.ai >> 14) & 3;
    n_mm = e.d & 63;
    n_gapo = (e.d >> 6) & 63;
    n_gape = (e.d >> 12) & 63;
    ldp = e.d >> 18;
    if (bucket > s.best_score + P.s_mm) {  // nothing better is left
      s.done = 1;
      return;
    }
    m = s.max_diff - (n_mm + n_gapo) - n_gape;
    if (m >= 0) {
      const int32_t* wd = a == 0 ? r.wid0 : r.wid1;
      const int p1 = fq_clamp(i - 1, 0, L), p2 = fq_clamp(i - 2, 0, L);
      ww_i2 = wd[2 * p1];
      wb_i2 = wd[2 * p1 + 1];
      ww_i2m1 = wd[2 * p2];
      wb_i2m1 = wd[2 * p2 + 1];
      alive = !(i > 0 && m < wb_i2);
    }
  }
  const bool hit_i0 = alive && i == 0;
  const bool start_chain = alive && i > 0 && m == 0;
  const bool expand = alive && !hit_i0 && !start_chain;

  // ---- exact walk (bwt_match_exact_alt), one base per step ----
  bool ch_hit = false;
  if (work_chain || start_chain) {
    const int cur_a = work_chain ? ch[3] : a;
    const int sel = 1 - cur_a;
    const int ck = work_chain ? ch[0] : k;
    const int cl = work_chain ? ch[1] : l;
    const int ch_i = work_chain ? ch[2] : i;
    const int cc = fq_seq_at(r.seq0, cur_a, fq_clamp(ch_i - 1, 0, L - 1));
    const int ccl = fq_clamp(cc, 0, 3);
    const int L2c = fm.L2[sel][ccl];
    const int nk = L2c + fm_occ1(fm, sel, ck - 1, ccl) + 1;
    const int nl = L2c + fm_occ1(fm, sel, cl, ccl);
    const bool dead = cc > 3 || nk > nl;
    ch_hit = !dead && ch_i - 1 == 0;
    s.ch_on = !dead && !ch_hit;
    ch[0] = nk;
    ch[1] = nl;
    ch[2] = ch_i - 1;
    ch[3] = cur_a;
    if (start_chain) {
      ch[4] = n_mm;
      ch[5] = n_gapo;
      ch[6] = n_gape;
      ch[7] = ldp;
    }
  } else {
    s.ch_on = 0;
  }

  // ---- hits ----
  if (hit_i0 || ch_hit) {
    const int hk = ch_hit ? ch[0] : k, hl = ch_hit ? ch[1] : l;
    const int hmm = ch_hit ? ch[4] : n_mm, hgo = ch_hit ? ch[5] : n_gapo;
    const int hge = ch_hit ? ch[6] : n_gape, ha = ch_hit ? ch[3] : a;
    const int hldp = ch_hit ? ch[7] : ldp;
    const int score = hmm * P.s_mm + hgo * P.s_gapo + hge * P.s_gape;
    if (s.n_aln == 0) {
      s.best_score = score;
      s.max_diff = fq_min(hmm + hgo + hge + 1, r.md);
    }
    const bool eq_best = score == s.best_score;
    if (!eq_best && s.best_cnt > P.max_top2) {
      done = true;
    } else {
      if (eq_best) s.best_cnt += hl - hk + 1;
      bool dup = false;
      if (hgo > 0)
        for (int j = 0; j < s.n_aln; ++j)
          if (alns[3 * j + 1] == hk && alns[3 * j + 2] == hl) {
            dup = true;
            break;
          }
      if (!dup) {
        fq_gap_shadow(ha == 0 ? r.wid0 : r.wid1, hldp, hl - hk + 1, n, L);
        if (s.n_aln < FQ_A_MAX) {
          alns[3 * s.n_aln] = hmm | (hgo << 6) | (hge << 12) | (ha << 18) |
                              (score << 19);
          alns[3 * s.n_aln + 1] = hk;
          alns[3 * s.n_aln + 2] = hl;
          ++s.n_aln;
        } else {
          s.overflow |= FQ_FB_AMAX;
        }
      }
    }
  }

  // ---- expansion (bwtgap.c:150-214) ----
  if (expand) {
    const int i2 = i - 1;
    const int occ_w = l - k + 1;
    bool allow_diff = !(i2 > 0 && wb_i2m1 > m - 1);
    bool allow_m = !(i2 > 0 && wb_i2m1 == m - 1 && wb_i2 == m - 1 &&
                     ww_i2m1 == ww_i2);
    const int msd = P.max_seed_diff - (n_mm + n_gapo) - n_gape;
    const int ii = i2 - (len - SL);
    if (r.use_seed && i2 > 0 && ii > 0) {
      const int32_t* sw = a == 0 ? r.sw0 : r.sw1;
      const int q1 = fq_clamp(ii - 1, 0, SL), q2 = fq_clamp(ii, 0, SL);
      if (sw[2 * q1 + 1] > msd - 1) allow_diff = false;
      if (sw[2 * q1 + 1] == msd - 1 && sw[2 * q2 + 1] == msd - 1 &&
          sw[2 * q1] == sw[2 * q2])
        allow_m = false;
    }
    const int tmp = n_gapo + n_gape;
    const bool indel_ok = allow_diff && i2 >= P.indel_end_skip + tmp &&
                          len - i2 >= P.indel_end_skip + tmp;
    const bool ins_open =
        indel_ok && state == FQ_STATE_M && n_gapo < P.max_gapo;
    const bool ins_ext =
        indel_ok && state == FQ_STATE_I && n_gape < P.max_gape;
    const bool del_open = ins_open;
    const bool del_ext = indel_ok && state == FQ_STATE_D &&
                         n_gape < P.max_gape &&
                         (n_gapo + n_gape < s.max_diff ||
                          occ_w < P.max_del_occ);
    const bool allow_mm = allow_diff && allow_m;

    const int sel = 1 - a;
    int cnt_k[4], cnt_l[4];
    fm_occ4(fm, sel, k - 1, cnt_k);
    fm_occ4(fm, sel, l, cnt_l);
    const int si = fq_seq_at(r.seq0, a, fq_clamp(i2, 0, L - 1));

    FqChildren cs;
    cs.n = 0;
    cs.bad_score = false;
    if (ins_open || ins_ext)
      fq_child(cs, P, a, i2, k, l, n_mm, n_gapo + ins_open,
               n_gape + ins_ext, FQ_STATE_I, i2);
    if (del_open || del_ext)
      for (int c = 0; c < 4; ++c) {
        const int kj = fm.L2[sel][c] + cnt_k[c] + 1;
        const int lj = fm.L2[sel][c] + cnt_l[c];
        if (kj <= lj)
          fq_child(cs, P, a, i2 + 1, kj, lj, n_mm, n_gapo + del_open,
                   n_gape + del_ext, FQ_STATE_D, i2 + 1);
      }
    for (int j = 1; j <= 4; ++j) {
      bool mask_j = allow_mm, is_mm = true;
      if (j == 4) {  // the read's own base: exact unless it is an N
        mask_j = allow_mm || si < 4;
        is_mm = allow_mm && si > 3;
      }
      if (!mask_j) continue;
      const int c = (si + j) & 3;
      const int kj = fm.L2[sel][c] + cnt_k[c] + 1;
      const int lj = fm.L2[sel][c] + cnt_l[c];
      if (kj <= lj)
        fq_child(cs, P, a, i2, kj, lj, n_mm + (is_mm ? 1 : 0), n_gapo,
                 n_gape, FQ_STATE_M, is_mm ? i2 : ldp);
    }
    const bool no_room = cs.n > NP - s.n_entries;
    if (cs.bad_score || no_room) {
      if (cs.bad_score) s.overflow |= FQ_FB_SCORE;
      if (no_room) s.overflow |= FQ_FB_POOL;
      done = true;
    } else {
      for (int c = 0; c < cs.n; ++c) {  // LIFO push, C order
        const int slot = s.ftop > 0 ? w.freel[--s.ftop] : s.bump++;
        const int b = cs.score[c];
        const uint32_t word = fq_bm_word(s, b >> 5);
        const bool nonempty = (word >> (b & 31)) & 1u;
        FqSlot e = cs.c[c];
        e.ai |= (nonempty ? (int)heads[b] : NP) << 16;
        pool[slot] = e;
        heads[b] = (int16_t)slot;
        fq_bm_put(s, b >> 5, word | (1u << (b & 31)));
      }
      s.n_entries += cs.n;
    }
  }

  if (done) {
    s.done = 1;
  } else if (++s.steps > P.step_cap) {  // per-read step cap -> fallback
    s.overflow |= FQ_FB_STEPCAP;
    s.done = 1;
  }
}

// Advance a read by at most max_steps steps, as the lockstep path does: a
// read that is already done takes no step.  Returns whether it is done.
FQ_HD bool fq_lane_steps(FqLane& s, const FmView& fm, const SearchParams& P,
                         const FqRead& r, const FqWork& w, int max_steps) {
  for (int t = 0; t < max_steps && !s.done; ++t) fq_lane_step(s, fm, P, r, w);
  return s.done != 0;
}

// The whole search of one read (the resident kernel's body).
FQ_HD SearchOut search_read(const FmView& fm, const SearchParams& P,
                            const uint8_t* seq0, int len, int md,
                            int use_seed, int n_n, int32_t* wid0,
                            int32_t* wid1, const int32_t* sw0,
                            const int32_t* sw1, FqSlot* pool,
                            uint16_t* freel, int16_t* heads, int32_t* alns) {
  const FqRead r = {seq0, len, md, use_seed, wid0, wid1, sw0, sw1};
  const FqWork w = {pool, freel, heads, alns};
  FqLane s;
  fq_lane_init(s, P, fm.n, r, n_n, w);
  while (!s.done) fq_lane_step(s, fm, P, r, w);
  const SearchOut out = {s.n_aln, s.overflow, s.steps};
  return out;
}

// The read inputs of chunk row `rid` (the layouts of fq_search_launch).
FQ_HD FqRead fq_chunk_read(const SearchParams& P, int rid, int N,
                           const uint8_t* seqs, const int32_t* lens,
                           const int32_t* md, const int32_t* use_seed,
                           int32_t* widths, const int32_t* seed_w) {
  const int64_t LW = 2 * (P.L + 1), SW = 2 * (P.SL + 1);
  const FqRead r = {seqs + (int64_t)rid * P.L, lens[rid], md[rid],
                    use_seed[rid], widths + rid * LW,
                    widths + (N + rid) * LW, seed_w + rid * SW,
                    seed_w + (N + rid) * SW};
  return r;
}

// The scan kernel's body for lane b: start the lane's read if the outer
// round marked it fresh, then advance it by at most k_inner steps.  An
// idle or finished lane is left untouched.  The read's inputs are the
// chunk's rows `rid`, so gap_shadow updates the chunk's width rows in
// place (a read lives in exactly one lane).  Workspace slabs are per lane.
FQ_HD void fq_scan_lane(int b, const FmView& fm, const SearchParams& P,
                        const uint8_t* seqs, const int32_t* lens,
                        const int32_t* md, const int32_t* use_seed,
                        const int32_t* n_n, int N, int32_t* widths,
                        const int32_t* seed_w, FqLane* lanes, FqSlot* pool,
                        uint16_t* freel, int16_t* heads, int32_t* alns,
                        int k_inner) {
  FqLane s = lanes[b];
  if (s.rid < 0 || s.done) return;
  const FqRead r = fq_chunk_read(P, s.rid, N, seqs, lens, md, use_seed,
                                 widths, seed_w);
  const FqWork w = {pool + (int64_t)b * P.NP, freel + (int64_t)b * P.NP,
                    heads + (int64_t)b * FQ_NBUCK,
                    alns + (int64_t)b * FQ_A_MAX * 3};
  if (s.fresh) fq_lane_init(s, P, fm.n, r, n_n[s.rid], w);
  fq_lane_steps(s, fm, P, r, w, k_inner);
  lanes[b] = s;
}
