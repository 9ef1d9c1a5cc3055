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
// - the bwt_match_exact_alt walk in a chain register, up to CH bases a step
//   (the chain length of the reference's resident kernel; the step cap
//   counts steps, so CH changes which reads reach it);
// - top2 cutoffs, at most A_MAX recorded hits and gap_shadow on the hit
//   strand's width row;
// - the per-read step cap counted as the lockstep path counts it (a step
//   that ends the search is not counted) and the FB_* fallback-cause bits.
//
// Pool slot identity is internal (slots only thread the bucket lists), so
// which slot an entry takes cannot change a result.  Slots come from a
// bump pointer plus a stack of recycled ones; the slot popped in a step is
// held in a register and given to the step's first child.
//
// The search is resumable: fq_lane_init sets a read up and fq_lane_step
// advances it by one step, with everything it carries between steps in an
// FqLane record plus the read's workspace.  fq_resident_read (search.cu)
// runs a read to the end; the scan kernel (scan.cu) advances each lane's
// read K_INNER steps a round and flushes and refills lanes between rounds
// (fq_scan_advance, fq_scan_flush, fq_scan_refill).
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
  int CH;  // chain length: exact-walk bases a step (>= 1)
};

FQ_HD SearchParams search_params(const int32_t* p) {
  SearchParams P;
  P.L = p[0]; P.SL = p[1]; P.NP = p[2]; P.step_cap = p[3];
  P.s_mm = p[4]; P.s_gapo = p[5]; P.s_gape = p[6]; P.max_gapo = p[7];
  P.max_gape = p[8]; P.indel_end_skip = p[9]; P.max_del_occ = p[10];
  P.max_entries = p[11]; P.max_top2 = p[12]; P.max_seed_diff = p[13];
  P.CH = p[14];
  return P;
}

// one pool entry: ai = i | a << 13 | state << 14 | next << 16 (next = NP
// is the null link); d = mm | go << 6 | ge << 12 | ldp << 18
struct alignas(16) FqSlot {
  int32_t k, l, ai, d;
};

// code of read strand `a` at position p (strand 1 is the complement)
FQ_HD int fq_seq_at(const uint8_t* seq0, int a, int p) {
  const int c = seq0[p];
  return (a == 0 || c > 3) ? c : 3 - c;
}

// [w, bid] pair p of a width row (rows start 8-byte aligned)
FQ_HD void fq_wpair(const int32_t* row, int p, int& w, int& bid) {
#if defined(__CUDA_ARCH__)
  const int2 v = *reinterpret_cast<const int2*>(row + 2 * p);
  w = v.x;
  bid = v.y;
#else
  w = row[2 * p];
  bid = row[2 * p + 1];
#endif
}

#define FQ_SHADOW_BATCH 16

// bwtgap.c:81-91 on the [w, bid] pairs of one width row.  The loads of a
// batch of positions are started before its stores, so a row costs a few
// memory round trips rather than one a position.
FQ_HD void fq_gap_shadow(int32_t* wd, int ldp, int x, int n, int L) {
  const int end = fq_min(ldp, L + 1);
  int j = 0;
  for (int p0 = 0; p0 < end; p0 += FQ_SHADOW_BATCH) {
    int w[FQ_SHADOW_BATCH];
#pragma unroll
    for (int u = 0; u < FQ_SHADOW_BATCH; ++u)
      w[u] = p0 + u < end ? wd[2 * (p0 + u)] : 0;
#pragma unroll
    for (int u = 0; u < FQ_SHADOW_BATCH; ++u) {
      const int p = p0 + u;
      if (p >= end) break;
      if (w[u] > x) {
        wd[2 * p] = w[u] - x;
      } else if (w[u] == x) {
        ++j;
        wd[2 * p] = n - j;
        wd[2 * p + 1] = 1;
      }
    }
  }
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

// One read's workspace: NP pool slots and the NP entries of their free
// stack; the FQ_NBUCK bucket heads, head b at [b * hs] (the resident
// kernel interleaves its threads' heads in shared memory, hs = threads of
// the block); alns: FQ_A_MAX rows of [packed, k, l].
struct FqWork {
  FqSlot* pool;
  uint16_t* freel;
  int16_t* heads;
  int32_t* alns;
  int hs;
};

FQ_HD int16_t& fq_head(const FqWork& w, int b) { return w.heads[b * w.hs]; }

// Everything the search carries from one step to the next besides the
// workspace, so a read can be suspended after any step and resumed later.
// Both kernels keep it in registers: the resident kernel for one read, the
// scan kernel for one lane across the rounds of a chunk.
struct FqLane {
  int32_t rid;       // the lane's read (-1: idle)
  int32_t done;      // the search ended (or the read is dead)
  int32_t fresh;     // set by the refill: init the read first
  int32_t n_aln, overflow, steps;
  int32_t n_entries, hwm;  // entries held; the most held at once
  int32_t bump, top;        // the pool's bump pointer, free-stack top
  int32_t best_score, best_cnt, max_diff;
  int32_t ch_on;
  uint32_t bm[4];  // non-empty buckets
  int32_t ch[8];   // exact-walk chain register
};

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
  s.hwm = 0;
  s.done = (r.md < 0 || n_n > r.md || r.len <= 0) ? 1 : 0;
  if (s.done) return;
  const FqSlot s0 = {0, n, r.len | (P.NP << 16), 0};
  const FqSlot s1 = {0, n, r.len | (1 << 13), 0};
  w.pool[0] = s0;
  w.pool[1] = s1;
  fq_head(w, 0) = 1;
  s.bm[0] = 1u; s.bm[1] = 0u; s.bm[2] = 0u; s.bm[3] = 0u;
  s.bump = 2;
  s.top = 0;
  s.n_entries = s.hwm = 2;
  s.best_score = (r.md + 1) * P.s_mm + (P.max_gapo + 1) * P.s_gapo +
                 (P.max_gape + 1) * P.s_gape;
  s.best_cnt = 0;
  s.max_diff = r.md;
}

// What the children of one expansion share (bwtgap.c:150-214).
struct FqExpand {
  int a, i2, k, l, n_mm, n_gapo, n_gape, ldp, si;
  bool ins_open, ins_ext, del_open, del_ext, allow_mm;
  int kk[4], ll[4];  // the interval of each base's backward extension
};

// The children of an expansion as a mask of bits x in C push order: x = 0
// the insertion, 1..4 the deletions c = x - 1, 5..8 the mismatches j =
// x - 4 (j = 4: the read's own base, exact unless it is an N).  Child x
// is of kind fq_kind(x) and goes to score bucket bk[kind]: 0 the
// insertion's, 1 the deletions', 2 the mismatches', 3 the own base's.
FQ_HD int fq_kind(int x) { return x == 0 ? 0 : x <= 4 ? 1 : x < 8 ? 2 : 3; }

FQ_HD uint32_t fq_children(const FqExpand& X, const SearchParams& P,
                           int bk[4]) {
  const int s0 = X.n_mm * P.s_mm + X.n_gapo * P.s_gapo + X.n_gape * P.s_gape;
  uint32_t v = 0;  // bases with a nonempty extension
#pragma unroll
  for (int c = 0; c < 4; ++c) v |= (X.kk[c] <= X.ll[c] ? 1u : 0u) << c;
  const bool ins = X.ins_open || X.ins_ext;
  const bool del = X.del_open || X.del_ext;
  uint32_t mask = (ins ? 1u : 0u) | (del ? v << 1 : 0u);
  if (X.allow_mm) {
#pragma unroll
    for (int j = 1; j <= 3; ++j)
      mask |= ((v >> ((X.si + j) & 3)) & 1u) << (4 + j);
  }
  if ((X.allow_mm || X.si < 4) && ((v >> (X.si & 3)) & 1u)) mask |= 1u << 8;
  bk[0] = s0 + X.ins_open * P.s_gapo + X.ins_ext * P.s_gape;
  bk[1] = s0 + X.del_open * P.s_gapo + X.del_ext * P.s_gape;
  bk[2] = s0 + P.s_mm;
  bk[3] = X.allow_mm && X.si > 3 ? bk[2] : s0;
  return mask;
}

// Child x (a bit of fq_children's mask): its pool entry, next link clear.
FQ_HD FqSlot fq_child(const FqExpand& X, int x) {
  const bool is_ins = x == 0, is_del = x >= 1 && x <= 4, is_mm = x >= 5;
  const int c = is_del ? x - 1 : (X.si + x - 4) & 3;
  const bool mm = is_mm && (x < 8 || (X.allow_mm && X.si > 3));
  const int n_mm = X.n_mm + (mm ? 1 : 0);
  const int go = X.n_gapo + (is_ins ? X.ins_open : is_del ? X.del_open : 0);
  const int ge = X.n_gape + (is_ins ? X.ins_ext : is_del ? X.del_ext : 0);
  const int state = is_ins ? FQ_STATE_I : is_del ? FQ_STATE_D : FQ_STATE_M;
  const int i = is_del ? X.i2 + 1 : X.i2;
  const int ldp = is_mm && !mm ? X.ldp : i;
  FqSlot e;
  e.k = is_ins ? X.k : fq_pick4(X.kk, c);
  e.l = is_ins ? X.l : fq_pick4(X.ll, c);
  e.ai = (state << 14) | (X.a << 13) | i;
  e.d = n_mm | (go << 6) | (ge << 12) | (ldp << 18);
  return e;
}

// A slot for a new entry: *x, the slot popped in this step, if it is not
// yet reused (then *x = -1), else the most recently freed slot, else a
// fresh one.
FQ_HD int fq_take_slot(FqLane& s, const FqWork& w, int* x) {
  const int slot = *x >= 0 ? *x : s.top > 0 ? w.freel[--s.top] : s.bump++;
  *x = -1;
  return slot;
}

// LIFO push of one entry onto bucket b's list.
FQ_HD void fq_push(FqLane& s, const FqWork& w, int NP, FqSlot e, int b,
                   int* x) {
  const int slot = fq_take_slot(s, w, x);
  const uint32_t word = fq_bm_word(s, b >> 5);
  const bool nonempty = (word >> (b & 31)) & 1u;
  e.ai |= (nonempty ? (int)fq_head(w, b) : NP) << 16;
  w.pool[slot] = e;
  fq_head(w, b) = (int16_t)slot;
  fq_bm_put(s, b >> 5, word | (1u << (b & 31)));
  ++s.n_entries;
}

// Bases 2..CH of a step's exact walk (the sub-step loop of the reference's
// resident kernel): while the walk goes on, one more base, each with the
// rank queries of its interval's two bounds.  Returns whether the walk
// reached the read's end (a hit); clears ch_on when it ends either way.
FQ_HD bool fq_chain_more(FqLane& s, const FmView& fm, const SearchParams& P,
                         const FqRead& r) {
  int* ch = s.ch;
  for (int t = 1; t < P.CH && s.ch_on; ++t) {
    const int a = ch[3], sel = 1 - a;
    const int base = fq_seq_at(r.seq0, a, fq_clamp(ch[2] - 1, 0, P.L - 1));
    int32_t row_k[12], row_l[12];
    const int rem_k = fm_load(fm, sel, ch[0] - 1, row_k);
    const int rem_l = fm_load(fm, sel, ch[1], row_l);
    const int c = fq_clamp(base, 0, 3);
    const int L2c = fm_L2(fm, sel, c);
    const int nk = L2c + fm_count(row_k, rem_k, c) + 1;
    const int nl = L2c + fm_count(row_l, rem_l, c);
    if (base > 3 || nk > nl) {
      s.ch_on = 0;
      return false;
    }
    ch[0] = nk;
    ch[1] = nl;
    ch[2] -= 1;
    if (ch[2] == 0) {
      s.ch_on = 0;
      return true;
    }
  }
  return false;
}

// One step of a read that is not done: pop (or one chain base), hits,
// expansion.  A step that ends the search sets `done` and is not counted;
// the per-read step cap counts the others.  Whatever path a read takes,
// the step starts its memory reads in two rounds: the popped entry, then
// one batch (its width and seed-width rows, the two FM table rows and the
// read base), so the paths of a warp's diverged reads wait on the same
// loads.  kChain compiles the walk's further bases (P.CH > 1) in; without
// it a step walks one base, whatever P.CH says.
template <bool kChain = false>
FQ_HD void fq_lane_step(FqLane& s, const FmView& fm, const SearchParams& P,
                        const FqRead& r, const FqWork& w) {
  const int n = fm.n, NP = P.NP, L = P.L, SL = P.SL;
  const int len = r.len;
  int32_t* alns = w.alns;
  int* ch = s.ch;
  const bool work_chain = s.ch_on;
  int k = 0, l = 0, a = 0, i = 0, state = 0, bucket = 0;
  int n_mm = 0, n_gapo = 0, n_gape = 0, ldp = 0, m = 0;
  int x = -1;  // the popped slot until it is reused or freed
  if (!work_chain) {
    // empty stack, or C's `n_entries > max_entries` break
    if (s.n_entries == 0 || s.n_entries > P.max_entries) {
      s.done = 1;
      return;
    }
    bucket = s.bm[0]   ? fq_ctz(s.bm[0])
             : s.bm[1] ? 32 + fq_ctz(s.bm[1])
             : s.bm[2] ? 64 + fq_ctz(s.bm[2])
             : s.bm[3] ? 96 + fq_ctz(s.bm[3])
                       : -1;
    if (bucket < 0) {
      s.done = 1;
      return;
    }
    x = fq_head(w, bucket);
    const FqSlot e = w.pool[x];
    const int nxt = (e.ai >> 16) & 0x7FFF;
    if (nxt == NP)
      fq_bm_put(s, bucket >> 5,
                fq_bm_word(s, bucket >> 5) & ~(1u << (bucket & 31)));
    else
      fq_head(w, bucket) = (int16_t)nxt;
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
    m = s.max_diff - (n_mm + n_gapo) - n_gape;
  }

  // ---- the step's batch of loads, the same for every path ----
  // the FM rows and the base of the chain's next base, or of the popped
  // entry's expansion (i - 1 on strand a)
  const int cur_a = work_chain ? ch[3] : a;
  const int sel = 1 - cur_a;
  const int ck = work_chain ? ch[0] : k;
  const int cl = work_chain ? ch[1] : l;
  const int ci = work_chain ? ch[2] : i;
  const int base = fq_seq_at(r.seq0, cur_a, fq_clamp(ci - 1, 0, L - 1));
  int32_t row_k[12], row_l[12];
  const int rem_k = fm_load(fm, sel, ck - 1, row_k);
  const int rem_l = fm_load(fm, sel, cl, row_l);
  // the popped entry's width and seed-width rows
  int ww_i2, wb_i2, ww_i2m1, wb_i2m1, sw1w, sw1b, sw2w, sw2b;
  const int ii = i - 1 - (len - SL);
  fq_wpair(a == 0 ? r.wid0 : r.wid1, fq_clamp(i - 1, 0, L), ww_i2, wb_i2);
  fq_wpair(a == 0 ? r.wid0 : r.wid1, fq_clamp(i - 2, 0, L), ww_i2m1,
           wb_i2m1);
  fq_wpair(a == 0 ? r.sw0 : r.sw1, fq_clamp(ii - 1, 0, SL), sw1w, sw1b);
  fq_wpair(a == 0 ? r.sw0 : r.sw1, fq_clamp(ii, 0, SL), sw2w, sw2b);

  int cnt_k[4], cnt_l[4], kk[4], ll[4];  // each base's backward extension
  fm_count4(row_k, rem_k, cnt_k);
  fm_count4(row_l, rem_l, cnt_l);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int L2c = fm_L2(fm, sel, c);
    kk[c] = L2c + cnt_k[c] + 1;
    ll[c] = L2c + cnt_l[c];
  }

  bool alive = false, done = false;
  if (!work_chain) {
    if (bucket > s.best_score + P.s_mm) {  // nothing better is left
      w.freel[s.top++] = (uint16_t)x;
      s.done = 1;
      return;
    }
    alive = m >= 0 && !(i > 0 && m < wb_i2);
  }
  const bool hit_i0 = alive && i == 0;
  const bool start_chain = alive && i > 0 && m == 0;
  const bool expand = alive && !hit_i0 && !start_chain;

  // ---- exact walk (bwt_match_exact_alt), up to CH bases a step ----
  bool ch_hit = false;
  if (work_chain || start_chain) {
    const int ccl = fq_clamp(base, 0, 3);
    const int nk = fq_pick4(kk, ccl), nl = fq_pick4(ll, ccl);
    const bool dead = base > 3 || nk > nl;
    ch_hit = !dead && ci - 1 == 0;
    s.ch_on = !dead && !ch_hit;
    ch[0] = nk;
    ch[1] = nl;
    ch[2] = ci - 1;
    ch[3] = cur_a;
    if (start_chain) {
      ch[4] = n_mm;
      ch[5] = n_gapo;
      ch[6] = n_gape;
      ch[7] = ldp;
    }
    if (kChain && s.ch_on) ch_hit = fq_chain_more(s, fm, P, r);
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
      if (hgo > 0)  // four hit rows a round of loads
        for (int j0 = 0; j0 < s.n_aln && !dup; j0 += 4) {
          int hk4[4], hl4[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const bool in = j0 + u < s.n_aln;
            hk4[u] = in ? alns[3 * (j0 + u) + 1] : -1;
            hl4[u] = in ? alns[3 * (j0 + u) + 2] : -1;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
            dup = dup || (hk4[u] == hk && hl4[u] == hl);
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
    FqExpand X;
    X.a = a;
    X.i2 = i - 1;
    X.k = k;
    X.l = l;
    X.n_mm = n_mm;
    X.n_gapo = n_gapo;
    X.n_gape = n_gape;
    X.ldp = ldp;
    X.si = base;
    const int i2 = X.i2;
    const int occ_w = l - k + 1;
    bool allow_diff = !(i2 > 0 && wb_i2m1 > m - 1);
    bool allow_m = !(i2 > 0 && wb_i2m1 == m - 1 && wb_i2 == m - 1 &&
                     ww_i2m1 == ww_i2);
    const int msd = P.max_seed_diff - (n_mm + n_gapo) - n_gape;
    if (r.use_seed && i2 > 0 && ii > 0) {
      if (sw1b > msd - 1) allow_diff = false;
      if (sw1b == msd - 1 && sw2b == msd - 1 && sw1w == sw2w)
        allow_m = false;
    }
    const int tmp = n_gapo + n_gape;
    const bool indel_ok = allow_diff && i2 >= P.indel_end_skip + tmp &&
                          len - i2 >= P.indel_end_skip + tmp;
    X.ins_open = indel_ok && state == FQ_STATE_M && n_gapo < P.max_gapo;
    X.ins_ext = indel_ok && state == FQ_STATE_I && n_gape < P.max_gape;
    X.del_open = X.ins_open;
    X.del_ext = indel_ok && state == FQ_STATE_D && n_gape < P.max_gape &&
                (n_gapo + n_gape < s.max_diff || occ_w < P.max_del_occ);
    X.allow_mm = allow_diff && allow_m;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      X.kk[c] = kk[c];
      X.ll[c] = ll[c];
    }
    // count the children and check their buckets before any push
    int bk[4];
    uint32_t kids = fq_children(X, P, bk);
    const bool bad_score = ((kids & 0x1u) && bk[0] >= FQ_NBUCK) ||
                           ((kids & 0x1Eu) && bk[1] >= FQ_NBUCK) ||
                           ((kids & 0xE0u) && bk[2] >= FQ_NBUCK) ||
                           ((kids & 0x100u) && bk[3] >= FQ_NBUCK);
    const int n_ch = fq_popc(kids);
    const bool no_room = n_ch > NP - s.n_entries;
    if (bad_score || no_room) {
      if (bad_score) s.overflow |= FQ_FB_SCORE;
      if (no_room) s.overflow |= FQ_FB_POOL;
      done = true;
    } else {
      while (kids) {  // LIFO pushes in C order
        const int c = fq_ctz(kids);
        kids &= kids - 1;
        const int b = fq_pick4(bk, fq_kind(c));
        fq_push(s, w, NP, fq_child(X, c), b, &x);
      }
      s.hwm = fq_max(s.hwm, s.n_entries);
    }
  }
  if (x >= 0) w.freel[s.top++] = (uint16_t)x;

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

// One chunk's read inputs (the layouts of fq_search_launch): seqs (N, L)
// reversed codes; lens, md, use_seed, n_n (N,); widths (2N, L+1, 2),
// strand-0 rows first, updated in place by gap_shadow; seed_w (2N, SL+1,
// 2).
struct FqChunk {
  const uint8_t* seqs;
  const int32_t *lens, *md, *use_seed, *n_n;
  int N;
  int32_t* widths;
  const int32_t* seed_w;
};

// The read inputs of chunk row `rid`.
FQ_HD FqRead fq_chunk_read(const SearchParams& P, const FqChunk& c, int rid) {
  const int64_t LW = 2 * (P.L + 1), SW = 2 * (P.SL + 1);
  const FqRead r = {c.seqs + (int64_t)rid * P.L, c.lens[rid], c.md[rid],
                    c.use_seed[rid], c.widths + rid * LW,
                    c.widths + (c.N + rid) * LW, c.seed_w + rid * SW,
                    c.seed_w + (c.N + rid) * SW};
  return r;
}

// Per-read outputs of the resident search, (N,) each but alns (N, 48, 3)
// (zeroed by the caller); hwm: the most pool slots the read held at once.
struct FqOut {
  int32_t *alns, *n_aln, *fb, *steps, *hwm;
};

// The whole search of chunk read `rid` in workspace w (the resident
// kernel's body; the read's hit rows are its rows of o.alns).  kChain as
// for fq_lane_step.
template <bool kChain>
FQ_HD void fq_resident_read(const FmView& fm, const SearchParams& P,
                            const FqChunk& c, int rid, FqWork w,
                            const FqOut& o) {
  const FqRead r = fq_chunk_read(P, c, rid);
  w.alns = o.alns + (int64_t)rid * FQ_A_MAX * 3;
  FqLane s;
  fq_lane_init(s, P, fm.n, r, c.n_n[rid], w);
  while (!s.done) fq_lane_step<kChain>(s, fm, P, r, w);
  o.n_aln[rid] = s.n_aln;
  o.fb[rid] = s.overflow;
  o.steps[rid] = s.steps;
  o.hwm[rid] = s.hwm;
}

// ---- the scan kernel's round pieces (scan.cu; host_kernels.cpp's
// fq_scan_host runs the same pieces lane by lane) ----

// Lanes a block of the scan kernel, and the stride of their interleaved
// bucket heads: 1,024 lanes on 32 SMs (about 1% faster than 128 lanes a
// block on 8 SMs, PERF.md).
#define FQ_SCAN_THREADS 32

// Start read `id` in a lane (the outer round's refill): an id >= N or a
// padding row (md < 0) leaves the lane idle (rid -1) for good, a dead read
// (more Ns than md, or empty) is done at once with no work, and any other
// read is marked fresh for fq_scan_advance to set up.
FQ_HD void fq_scan_refill(FqLane& s, const FqChunk& c, int id) {
  const int r = fq_min(id, c.N - 1);
  const bool valid = id < c.N && c.md[r] >= 0;
  const bool dead = !valid || c.n_n[r] > c.md[r] || c.lens[r] <= 0;
  s.rid = valid ? id : -1;
  s.done = dead ? 1 : 0;
  s.fresh = dead ? 0 : 1;
  s.n_aln = 0;
  s.overflow = 0;
  s.steps = 0;
}

// One round of a lane: if it holds a read that is not done, set the read
// up if it is fresh, then advance it by at most k_inner steps.  The read's
// inputs are the chunk's rows `rid` (gap_shadow updates its width rows in
// place: a read lives in exactly one lane) and its hit rows are its rows
// of o.alns, which the caller zeroed.
FQ_HD void fq_scan_advance(FqLane& s, const FmView& fm, const SearchParams& P,
                           const FqChunk& c, FqWork w, const FqOut& o,
                           int k_inner) {
  if (s.rid < 0 || s.done) return;
  const FqRead r = fq_chunk_read(P, c, s.rid);
  w.alns = o.alns + (int64_t)s.rid * FQ_A_MAX * 3;
  if (s.fresh) fq_lane_init(s, P, fm.n, r, c.n_n[s.rid], w);
  fq_lane_steps(s, fm, P, r, w, k_inner);
}

// Flush a lane that is done and holds a read: its n_aln, fallback bits and
// steps go to the read's rows (its hit rows are there already).  Returns
// whether the lane flushed; the caller then refills it.
FQ_HD bool fq_scan_flush(const FqLane& s, const FqOut& o) {
  if (!s.done || s.rid < 0) return false;
  o.n_aln[s.rid] = s.n_aln;
  o.fb[s.rid] = s.overflow;
  o.steps[s.rid] = s.steps;
  return true;
}
