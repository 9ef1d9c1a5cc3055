// bwape.c's pairing (libbwa/bwape.c:119-215) for one read pair: the sweep
// over the pair's merged occurrence list in C's sort order, then the pair
// mapQ and each end's update (ops/pe_device.pairing_sweep_plain and
// _pairing_result).  The pair-score key is C's own uint64_t, with its
// quirks: the hash's high word OR-collides into the score word, and
// "s>>32 < (o_score<<32 & U64MAX)" reduces to "o_score's low word is not
// 0".  The kernel (pairing.cu, one thread a pair) and the host build
// (host_kernels.cpp) share it.
//
// Inputs of pair p (row-major planes):
//   pos  (P, NK) int32  the sorted entries' positions
//   ent  (P, NK) int32  valid entry: its row's packed word (bits 0..25:
//                       mm | go<<6 | ge<<12 | strand<<18 | score<<19) |
//                       end << 26 | 1 << 27; invalid entry: 0.  The
//                       valid entries are a prefix of each row (the sort
//                       puts the invalid ones last), so the sweep stops
//                       at the first invalid one
//   se   (2, 8, P) int32  per end: pos, strand, mapq, seq_q, n_mm, n_gapo,
//                       n_gape, len
//   pen  int32 table    the insert-size penalty of l at pen[l] for l in
//                       [0, high_b] (read only when has_high)
//   g_log_n (256,) int32
// Outputs: out (2, 8, P) int32 per end: pos, strand, mapq, seq_q, n_mm,
// n_gapo, n_gape, proper; the return value counts the ends whose position
// or strand moved with a mapQ > 0 (cnt_chg's share).
#pragma once

#include "fq_common.cuh"

#define FQ_PAIR_META 0x3FFFFFF
#define FQ_PAIR_U64MAX 0xFFFFFFFFFFFFFFFFull

struct FqPairParams {
  int has_high;    // ii's high bound is set: the window and the penalty
  int64_t high_b;  // ii's Bayesian high bound
  int max_isize;   // the window without it
  int s_mm;
};

// hash_64 (bwtaln's khash integer mix)
FQ_HD uint64_t fq_hash64(uint64_t key) {
  key += ~(key << 32);
  key ^= key >> 22;
  key += ~(key << 13);
  key ^= key >> 8;
  key += key << 3;
  key ^= key >> 15;
  key += ~(key << 27);
  key ^= key >> 31;
  return key;
}

// A forward entry kept for pairing: its position and packed word.
struct FqPairSlot {
  int32_t pos, meta;
  bool valid;
};

FQ_HD int fq_pair_sweep(int p, int P, int NK, const int32_t* pos_s,
                        const int32_t* ent_s, const int32_t* se,
                        const int32_t* pen, const int32_t* g_log_n,
                        const FqPairParams& prm, int32_t* out) {
  const int32_t* sp = se + p;
  const int64_t len0 = sp[7 * P], len1 = sp[15 * P];
  const int64_t max_len = len0 > len1 ? len0 : len1;
  // the last two forward entries of each end (slot 1 the most recent)
  FqPairSlot l00 = {0, 0, false}, l01 = l00, l10 = l00, l11 = l00;
  uint64_t o = FQ_PAIR_U64MAX, s2 = FQ_PAIR_U64MAX;
  int32_t o_n = 0, subo_n = 0;
  bool found = false;
  int32_t u_pos = 0, u_meta = 0, v_pos = 0, v_meta = 0, u_end = 0;
  const int64_t row = (int64_t)p * NK;
  for (int t = 0; t < NK; ++t) {
    const int32_t ent = ent_s[row + t];
    if (!((ent >> 27) & 1)) break;
    const int32_t e_pos = pos_s[row + t];
    const int e_end = (ent >> 26) & 1;
    const int32_t meta = ent & FQ_PAIR_META;
    if (((meta >> 18) & 1) == 0) {  // forward: into this end's slots
      const FqPairSlot e = {e_pos, meta, true};
      if (e_end) {
        l10 = l11;
        l11 = e;
      } else {
        l00 = l01;
        l01 = e;
      }
      continue;
    }
    // reverse: pair with the opposite end's slot 1, then slot 0
    const int opp = 1 - e_end;
    const int64_t e_len = e_end ? len1 : len0;
    const int e_score = (meta >> 19) & 127;
#pragma unroll
    for (int slot = 1; slot >= 0; --slot) {
      const FqPairSlot u = opp ? (slot ? l11 : l10) : (slot ? l01 : l00);
      const int64_t l = (int64_t)e_pos + e_len - u.pos;
      const bool gate = u.valid && e_pos > u.pos && l >= max_len &&
                        (prm.has_high ? l <= prm.high_b : l <= prm.max_isize);
      if (!gate) continue;
      // the score word wraps as C's int does
      uint32_t s = (uint32_t)((e_score + ((u.meta >> 19) & 127)) * 10);
      if (prm.has_high) s += (uint32_t)pen[l];
      const uint64_t key =
          ((uint64_t)s << 32) |
          fq_hash64(((uint64_t)(uint32_t)u.pos << 32) | (uint32_t)e_pos);
      const bool same_hi = (key >> 32) == (o >> 32);
      const bool reset = !same_hi && (uint32_t)o != 0;
      subo_n += reset ? o_n : (same_hi ? 0 : 1);
      o_n = same_hi ? o_n + 1 : (reset ? 1 : o_n);
      if (key < o) {
        s2 = o;
        o = key;
        found = true;
        u_pos = u.pos;
        u_meta = u.meta;
        u_end = opp;
        v_pos = e_pos;
        v_meta = meta;
      } else if (key < s2) {
        s2 = key;
      }
    }
  }

  int32_t* op = out + p;
  if (!found) {  // every end as it came, not proper
    for (int j = 0; j < 2; ++j) {
      for (int f = 0; f < 7; ++f) op[(8 * j + f) * P] = sp[(8 * j + f) * P];
      op[(8 * j + 7) * P] = 0;
    }
    return 0;
  }
  // mapQ_p (bwape.c:169-181): the high words' difference as C's uint64
  // subtraction leaves it; only a difference <= s_mm * 10 reaches g_log_n
  const int64_t diff = (uint32_t)((uint32_t)(s2 >> 32) - (uint32_t)(o >> 32));
  const int n_cap = fq_clamp(subo_n, 0, 255);
  int64_t mapq_p = 0;
  if (o_n == 1) {
    if (s2 == FQ_PAIR_U64MAX)
      mapq_p = 29;
    else if (diff > (int64_t)prm.s_mm * 10)
      mapq_p = 23;
    else {
      mapq_p = diff / 2 - g_log_n[n_cap];
      if (mapq_p < 0) mapq_p = 0;
    }
  }
  // the chosen entry of each end
  const int32_t ch_pos[2] = {u_end == 0 ? u_pos : v_pos,
                             u_end == 0 ? v_pos : u_pos};
  const int32_t ch_meta[2] = {u_end == 0 ? u_meta : v_meta,
                              u_end == 0 ? v_meta : u_meta};
  bool m[2];
  int64_t mq[2], sq[2];
  for (int j = 0; j < 2; ++j) {
    m[j] = sp[8 * j * P] == ch_pos[j] &&
           sp[(8 * j + 1) * P] == ((ch_meta[j] >> 18) & 1);
    mq[j] = sp[(8 * j + 2) * P];
    sq[j] = sp[(8 * j + 3) * P];
  }
  const bool both = m[0] && m[1];
  const bool both_pos = both && mq[0] > 0 && mq[1] > 0;
  const int64_t mq_sum = mq[0] + mq[1] < 60 ? mq[0] + mq[1] : 60;
  int64_t nmq0 = both_pos ? mq_sum : mq[0];
  int64_t nmq1 = both_pos ? mq_sum : mq[1];
  int64_t nsq0 = sq[0], nsq1 = sq[1];
  if (both && !both_pos && mq[0] == 0)
    nmq0 = mapq_p + 7 < nmq1 ? mapq_p + 7 : nmq1;
  if (both && !both_pos && mq[1] == 0)
    nmq1 = mapq_p + 7 < nmq0 ? mapq_p + 7 : nmq0;
  if (m[0] && !m[1]) {
    nsq1 = 0;
    nmq1 = mq[0] < mapq_p ? mq[0] : mapq_p;
  }
  if (m[1] && !m[0]) {
    nsq0 = 0;
    nmq0 = mq[1] < mapq_p ? mq[1] : mapq_p;
  }
  if (!m[0] && !m[1]) {
    const int64_t mq_n = mapq_p > 20 ? mapq_p - 20 : 0;
    nsq0 = nsq1 = 0;
    nmq0 = nmq1 = mq_n;
  }
  const int64_t nmq[2] = {nmq0, nmq1}, nsq[2] = {nsq0, nsq1};
  int chg = 0;
  for (int j = 0; j < 2; ++j) {
    const int32_t mt = ch_meta[j], rst = (mt >> 18) & 1;
    const bool moved = sp[8 * j * P] != ch_pos[j] ||
                       sp[(8 * j + 1) * P] != rst;
    const int32_t vals[7] = {ch_pos[j],
                             rst,
                             (int32_t)nmq[j],
                             (int32_t)nsq[j],
                             mt & 63,
                             (mt >> 6) & 63,
                             (mt >> 12) & 63};
    for (int f = 0; f < 7; ++f) {
      const bool take = f == 2 || f == 3 || moved;
      op[(8 * j + f) * P] = take ? vals[f] : sp[(8 * j + f) * P];
    }
    op[(8 * j + 7) * P] = 1;
    chg += moved && (int32_t)nmq[j] > 0;
  }
  return chg;
}
