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

// seq0: L reversed read codes (strand 0).  wid0/wid1: the strands'
// (L + 1) [w, bid] width rows, updated in place by gap_shadow.  sw0/sw1:
// the strands' (SL + 1) seed width rows.  pool/freel: NP-slot workspace;
// heads: FQ_NBUCK entries; alns: FQ_A_MAX rows of [packed, k, l].
FQ_HD SearchOut search_read(const FmView& fm, const SearchParams& P,
                            const uint8_t* seq0, int len, int md,
                            int use_seed, int n_n, int32_t* wid0,
                            int32_t* wid1, const int32_t* sw0,
                            const int32_t* sw1, FqSlot* pool,
                            uint16_t* freel, int16_t* heads, int32_t* alns) {
  SearchOut out = {0, 0, 0};
  // md < 0 marks a padding row; dead reads finish with no work
  if (md < 0 || n_n > md || len <= 0) return out;
  const int n = fm.n, NP = P.NP, L = P.L, SL = P.SL;

  pool[0].k = 0; pool[0].l = n; pool[0].ai = len | (NP << 16); pool[0].d = 0;
  pool[1].k = 0; pool[1].l = n; pool[1].ai = len | (1 << 13); pool[1].d = 0;
  heads[0] = 1;
  uint32_t bm[4] = {1u, 0u, 0u, 0u};  // non-empty buckets
  int bump = 2, ftop = 0, n_entries = 2;
  int best_score = (md + 1) * P.s_mm + (P.max_gapo + 1) * P.s_gapo +
                   (P.max_gape + 1) * P.s_gape;
  int best_cnt = 0, n_aln = 0, max_diff = md, overflow = 0, steps = 0;
  bool ch_on = false;
  int ch[8] = {0, 0, 0, 0, 0, 0, 0, 0};

  for (;;) {
    const bool work_chain = ch_on;
    int k = 0, l = 0, a = 0, i = 0, state = 0;
    int n_mm = 0, n_gapo = 0, n_gape = 0, ldp = 0, m = 0;
    int ww_i2 = 0, ww_i2m1 = 0, wb_i2 = 0, wb_i2m1 = 0;
    bool alive = false, done = false;
    if (!work_chain) {
      // empty stack, or C's `n_entries > max_entries` break
      if (n_entries == 0 || n_entries > P.max_entries) break;
      int bucket = -1;
      for (int w = 0; w < 4; ++w)
        if (bm[w]) {
          bucket = 32 * w + fq_ctz(bm[w]);
          break;
        }
      if (bucket < 0) break;
      const int slot = heads[bucket];
      const FqSlot e = pool[slot];
      const int nxt = (e.ai >> 16) & 0x7FFF;
      if (nxt == NP)
        bm[bucket >> 5] &= ~(1u << (bucket & 31));
      else
        heads[bucket] = (int16_t)nxt;
      freel[ftop++] = (uint16_t)slot;
      --n_entries;
      k = e.k;
      l = e.l;
      a = (e.ai >> 13) & 1;
      i = e.ai & 0x1FFF;
      state = (e.ai >> 14) & 3;
      n_mm = e.d & 63;
      n_gapo = (e.d >> 6) & 63;
      n_gape = (e.d >> 12) & 63;
      ldp = e.d >> 18;
      if (bucket > best_score + P.s_mm) break;  // nothing better is left
      m = max_diff - (n_mm + n_gapo) - n_gape;
      if (m >= 0) {
        const int32_t* wd = a == 0 ? wid0 : wid1;
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
      const int cc = fq_seq_at(seq0, cur_a, fq_clamp(ch_i - 1, 0, L - 1));
      const int ccl = fq_clamp(cc, 0, 3);
      const int L2c = fm.L2[sel][ccl];
      const int nk = L2c + fm_occ1(fm, sel, ck - 1, ccl) + 1;
      const int nl = L2c + fm_occ1(fm, sel, cl, ccl);
      const bool dead = cc > 3 || nk > nl;
      ch_hit = !dead && ch_i - 1 == 0;
      ch_on = !dead && !ch_hit;
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
      ch_on = false;
    }

    // ---- hits ----
    if (hit_i0 || ch_hit) {
      const int hk = ch_hit ? ch[0] : k, hl = ch_hit ? ch[1] : l;
      const int hmm = ch_hit ? ch[4] : n_mm, hgo = ch_hit ? ch[5] : n_gapo;
      const int hge = ch_hit ? ch[6] : n_gape, ha = ch_hit ? ch[3] : a;
      const int hldp = ch_hit ? ch[7] : ldp;
      const int score = hmm * P.s_mm + hgo * P.s_gapo + hge * P.s_gape;
      if (n_aln == 0) {
        best_score = score;
        max_diff = fq_min(hmm + hgo + hge + 1, md);
      }
      const bool eq_best = score == best_score;
      if (!eq_best && best_cnt > P.max_top2) {
        done = true;
      } else {
        if (eq_best) best_cnt += hl - hk + 1;
        bool dup = false;
        if (hgo > 0)
          for (int j = 0; j < n_aln; ++j)
            if (alns[3 * j + 1] == hk && alns[3 * j + 2] == hl) {
              dup = true;
              break;
            }
        if (!dup) {
          fq_gap_shadow(ha == 0 ? wid0 : wid1, hldp, hl - hk + 1, n, L);
          if (n_aln < FQ_A_MAX) {
            alns[3 * n_aln] = hmm | (hgo << 6) | (hge << 12) | (ha << 18) |
                              (score << 19);
            alns[3 * n_aln + 1] = hk;
            alns[3 * n_aln + 2] = hl;
            ++n_aln;
          } else {
            overflow |= FQ_FB_AMAX;
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
      if (use_seed && i2 > 0 && ii > 0) {
        const int32_t* sw = a == 0 ? sw0 : sw1;
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
                           (n_gapo + n_gape < max_diff ||
                            occ_w < P.max_del_occ);
      const bool allow_mm = allow_diff && allow_m;

      const int sel = 1 - a;
      int cnt_k[4], cnt_l[4];
      fm_occ4(fm, sel, k - 1, cnt_k);
      fm_occ4(fm, sel, l, cnt_l);
      const int si = fq_seq_at(seq0, a, fq_clamp(i2, 0, L - 1));

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
      const bool no_room = cs.n > NP - n_entries;
      if (cs.bad_score || no_room) {
        if (cs.bad_score) overflow |= FQ_FB_SCORE;
        if (no_room) overflow |= FQ_FB_POOL;
        done = true;
      } else {
        for (int c = 0; c < cs.n; ++c) {  // LIFO push, C order
          const int slot = ftop > 0 ? freel[--ftop] : bump++;
          const int b = cs.score[c];
          const bool nonempty = (bm[b >> 5] >> (b & 31)) & 1u;
          FqSlot s = cs.c[c];
          s.ai |= (nonempty ? (int)heads[b] : NP) << 16;
          pool[slot] = s;
          heads[b] = (int16_t)slot;
          bm[b >> 5] |= 1u << (b & 31);
        }
        n_entries += cs.n;
      }
    }

    if (done) break;
    if (++steps > P.step_cap) {  // per-read step cap -> exact fallback
      overflow |= FQ_FB_STEPCAP;
      break;
    }
  }
  out.n_aln = n_aln;
  out.fb = overflow;
  out.steps = steps;
  return out;
}
