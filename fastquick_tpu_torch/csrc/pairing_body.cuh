// bwape.c's pairing (libbwa/bwape.c:119-215) for one read pair, the whole
// of ops/pe_device.pairing_sweep: the pair's merged occurrence entries put
// in C's sort order, the sweep over them, then the pair mapQ and each
// end's update (pairing_sweep_plain, _merged_entries, _pairing_result).
// The kernels (pairing.cu) and the host build (host_kernels.cpp) share it.
//
// The order.  C sorts the entries by the u64 pos<<32 | row<<1 | end; the
// plain version (and the reference package) by two stable argsorts, the
// sub-key row<<1|end first, with 0x7FFFFFFF for an invalid entry's pos and
// sub.  Here each valid entry is the 64-bit key
//   (uint32)(pos ^ 0x80000000) << 32 | (row << 1 | end) << 8
//     | strand << 7 | score
// (the flipped sign bit keeps signed positions in order; strand and score
// are its row's, all the sweep reads of the row's word) and a bitonic
// compare-exchange network sorts them, padded with all-ones keys.  Any
// correct sort of these keys gives the plain order of the valid entries:
// strand and score are functions of (row, end), so two entries with one
// (pos, row, end) -- one entry, twice -- have one key and their order
// changes nothing; a valid entry at pos 2^31-1 sorts before the invalid
// ones in the plain order too (its sub is below 0x7FFFFFFF), and the
// sweep never reads past the valid ones.  The pair's valid entries are
// each end's prefix t < min(n_occ, K) (expand_occurrences), none when the
// pair does not enter pairing.  Rows are below 2^23 (A_MAX is 48).
//
// The sweep.  The pair-score key is C's own uint64_t, with its quirks: the
// hash's high word OR-collides into the score word, and "s>>32 <
// (o_score<<32 & U64MAX)" reduces to "o_score's low word is not 0".  The
// float32 insert-size penalty comes as an integer table pen[l], l in [0,
// high_b], that the wrapper builds with the plain version's own torch
// operations, so nothing here is float arithmetic.
//
// Inputs (FqPairIn): per end j, pos[j] and row[j] (P, K) int32 and n_occ[j]
// (P,) int32; alns[j], the packed hit rows, the word of row r of pair p at
// alns[j][p * a_stride[j] + 3 r] (bits 0..25: mm | go<<6 | ge<<12 |
// strand<<18 | score<<19); pair_ok (P,) bool; the SE state, field f of end
// j (SE_FIELDS order: pos, strand, mapq, seq_q, n_mm, n_gapo, n_gape, len)
// at se.base[8 j + f], int64 or int32, with its stride; pen; g_log_n (256,).
// Outputs (FqPairOut): out (2, 7, P) int32 per end pos, strand, mapq, seq_q,
// n_mm, n_gapo, n_gape; proper (2, P) bool; cnt += the ends whose position
// or strand moved with a mapQ > 0 (cnt_chg).
#pragma once

#include "fq_common.cuh"

#define FQ_PAIR_U64MAX 0xFFFFFFFFFFFFFFFFull
#define FQ_PAIR_PAD 0xFFFFFFFFFFFFFFFFull  // the network's padding key
#define FQ_PAIR_WARP_NK 64  // key slots of a warp (the warp kernel's 2 K)

struct FqPairParams {
  int has_high;    // ii's high bound is set: the window and the penalty
  int64_t high_b;  // ii's Bayesian high bound
  int max_isize;   // the window without it
  int s_mm;
};

struct FqPairSe {
  const void* base[16];
  int64_t stride[16];  // elements
  int32_t is64[16];
};

struct FqPairIn {
  int P, K;
  const int32_t* pos[2];
  const int32_t* row[2];
  const int32_t* n_occ[2];
  const int32_t* alns[2];
  int64_t a_stride[2];
  const uint8_t* pair_ok;
  FqPairSe se;
  const int32_t* pen;
  const int32_t* g_log_n;
  FqPairParams prm;
};

struct FqPairOut {
  int32_t* out;
  uint8_t* proper;
  int32_t* cnt;
};

// The inputs of the C interface (fq_pairing_launch, fq_pairing_host), and
// their names; se_desc: 48 int64, the SE fields' addresses, strides and
// is64 flags.
#define FQ_PAIR_IN_ARGS                                                     \
  int P, int K, const int32_t *pos0, const int32_t *row0,                   \
      const int32_t *n_occ0, const int32_t *pos1, const int32_t *row1,      \
      const int32_t *n_occ1, const int32_t *alns0, long long a_stride0,     \
      const int32_t *alns1, long long a_stride1, const uint8_t *pair_ok,    \
      const long long *se_desc, const int32_t *pen, const int32_t *g_log_n, \
      int has_high, long long high_b, int max_isize, int s_mm
#define FQ_PAIR_IN_NAMES                                                   \
  P, K, pos0, row0, n_occ0, pos1, row1, n_occ1, alns0, a_stride0, alns1,   \
      a_stride1, pair_ok, se_desc, pen, g_log_n, has_high, high_b,         \
      max_isize, s_mm

static inline FqPairIn fq_pair_in(FQ_PAIR_IN_ARGS) {
  FqPairIn in;
  in.P = P;
  in.K = K;
  in.pos[0] = pos0;
  in.pos[1] = pos1;
  in.row[0] = row0;
  in.row[1] = row1;
  in.n_occ[0] = n_occ0;
  in.n_occ[1] = n_occ1;
  in.alns[0] = alns0;
  in.alns[1] = alns1;
  in.a_stride[0] = a_stride0;
  in.a_stride[1] = a_stride1;
  in.pair_ok = pair_ok;
  for (int f = 0; f < 16; ++f) {
    in.se.base[f] = (const void*)(intptr_t)se_desc[f];
    in.se.stride[f] = se_desc[16 + f];
    in.se.is64[f] = (int32_t)se_desc[32 + f];
  }
  in.pen = pen;
  in.g_log_n = g_log_n;
  in.prm = FqPairParams{has_high, (int64_t)high_b, max_isize, s_mm};
  return in;
}

// SE field f (8 * end + index) of pair p as int32 (the plain version's
// .to(int32)); f is a constant wherever this is inlined
FQ_HD int32_t fq_pair_se(const FqPairIn& in, int f, int p) {
  const int64_t i = (int64_t)p * in.se.stride[f];
  return in.se.is64[f] ? (int32_t)((const int64_t*)in.se.base[f])[i]
                       : ((const int32_t*)in.se.base[f])[i];
}

// a read-only input word (the read-only data path on the card)
FQ_HD int32_t fq_pair_ld(const int32_t* x) {
#if defined(__CUDA_ARCH__)
  return __ldg(x);
#else
  return *x;
#endif
}

// the valid entries of pair p's ends
FQ_HD void fq_pair_counts(const FqPairIn& in, int p, int& c0, int& c1) {
  const bool ok = in.pair_ok[p] != 0;
  c0 = ok ? fq_clamp(fq_pair_ld(in.n_occ[0] + p), 0, in.K) : 0;
  c1 = ok ? fq_clamp(fq_pair_ld(in.n_occ[1] + p), 0, in.K) : 0;
}

// the network's length for n keys: the least power of two >= n
FQ_HD int fq_pair_span(int n) {
  int m = 1;
  while (m < n) m <<= 1;
  return m;
}

// The warp kernel sorts its pairs in groups: consecutive pairs that share
// its 64 key slots, each in a segment of the group's largest span M.  A
// group takes the next pair (of span `span`) while the grown group still
// fits.  Starts a group at (g 1, M the first pair's span).
FQ_HD bool fq_pair_group_takes(int g, int& M, int span) {
  const int m2 = M > span ? M : span;
  if ((g + 1) * m2 > FQ_PAIR_WARP_NK) return false;
  M = m2;
  return true;
}

// the packed word of row `row` of end e of pair p
FQ_HD int32_t fq_pair_word(const FqPairIn& in, int p, int e, int row) {
  return fq_pair_ld((e ? in.alns[1] + (int64_t)p * in.a_stride[1]
                       : in.alns[0] + (int64_t)p * in.a_stride[0]) +
                    3 * row);
}

// element i of pair p's list before the sort: end 0's c0 valid entries,
// then end 1's, up to n; padding past them
FQ_HD uint64_t fq_pair_key(const FqPairIn& in, int p, int i, int c0, int n) {
  if (i >= n) return FQ_PAIR_PAD;
  const int e = i >= c0;
  const int64_t at = (int64_t)p * in.K + (e ? i - c0 : i);
  const int32_t pos = fq_pair_ld((e ? in.pos[1] : in.pos[0]) + at);
  const int32_t row = fq_pair_ld((e ? in.row[1] : in.row[0]) + at);
  const int32_t w = fq_pair_word(in, p, e, row);
  return ((uint64_t)((uint32_t)pos ^ 0x80000000u) << 32) |
         (uint32_t)(((row << 1) | e) << 8) | (((w >> 18) & 1) << 7) |
         ((w >> 19) & 127);
}

// One compare-exchange of the bitonic network: element i of stage (k, j)
// against its partner i ^ j, i its index within its pair's segment.  The
// lower of the two keeps the smaller key where its k-block ascends (i & k
// == 0), the larger where it descends; the last stages (k the segment's
// length) leave the segment ascending.
FQ_HD uint64_t fq_pair_cx(uint64_t mine, uint64_t other, int i, int j,
                          int k) {
  const bool keep_min = ((i & j) == 0) == ((i & k) == 0);
  const bool lt = other < mine;
  return keep_min ? (lt ? other : mine) : (lt ? mine : other);
}

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

// A forward entry kept for pairing: its position, row and score.
struct FqPairSlot {
  int32_t pos, row, score;
  bool valid;
};

// The sweep over pair p's n sorted keys (key t at keys[t * stride]) and
// its result into `o`; returns the pair's share of cnt_chg.
FQ_HD int fq_pair_sweep(const FqPairIn& in, int p, const uint64_t* keys,
                        int64_t stride, int n, const FqPairOut& o) {
  const FqPairParams& prm = in.prm;
  const int P = in.P;
  const int64_t len0 = fq_pair_se(in, 7, p), len1 = fq_pair_se(in, 15, p);
  const int64_t max_len = len0 > len1 ? len0 : len1;
  // the last two forward entries of each end (slot 1 the most recent)
  FqPairSlot l00 = {0, 0, 0, false}, l01 = l00, l10 = l00, l11 = l00;
  uint64_t o_key = FQ_PAIR_U64MAX, s2 = FQ_PAIR_U64MAX;
  int32_t o_n = 0, subo_n = 0;
  bool found = false;
  int32_t u_pos = 0, u_row = 0, v_pos = 0, v_row = 0, u_end = 0;
  uint64_t next = n > 0 ? keys[0] : 0;
  for (int t = 0; t < n; ++t) {
    const uint64_t k = next;  // the next key's load in flight meanwhile
    if (t + 1 < n) next = keys[(t + 1) * stride];
    const int32_t e_pos = (int32_t)((uint32_t)(k >> 32) ^ 0x80000000u);
    const uint32_t lo = (uint32_t)k;
    const int e_end = (lo >> 8) & 1, e_row = (int)(lo >> 9);
    const int e_score = lo & 127;
    if (((lo >> 7) & 1) == 0) {  // forward: into this end's slots
      const FqPairSlot e = {e_pos, e_row, e_score, true};
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
#pragma unroll
    for (int slot = 1; slot >= 0; --slot) {
      const FqPairSlot u = opp ? (slot ? l11 : l10) : (slot ? l01 : l00);
      const int64_t l = (int64_t)e_pos + e_len - u.pos;
      const bool gate = u.valid && e_pos > u.pos && l >= max_len &&
                        (prm.has_high ? l <= prm.high_b : l <= prm.max_isize);
      if (!gate) continue;
      // the score word wraps as C's int does
      uint32_t s = (uint32_t)((e_score + u.score) * 10);
      if (prm.has_high) s += (uint32_t)in.pen[l];
      const uint64_t key =
          ((uint64_t)s << 32) |
          fq_hash64(((uint64_t)(uint32_t)u.pos << 32) | (uint32_t)e_pos);
      const bool same_hi = (key >> 32) == (o_key >> 32);
      const bool reset = !same_hi && (uint32_t)o_key != 0;
      subo_n += reset ? o_n : (same_hi ? 0 : 1);
      o_n = same_hi ? o_n + 1 : (reset ? 1 : o_n);
      if (key < o_key) {
        s2 = o_key;
        o_key = key;
        found = true;
        u_pos = u.pos;
        u_row = u.row;
        u_end = opp;
        v_pos = e_pos;
        v_row = e_row;
      } else if (key < s2) {
        s2 = key;
      }
    }
  }

  int32_t* op = o.out + p;
  if (!found) {  // every end as it came, not proper
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int f = 0; f < 7; ++f)
        op[(7 * j + f) * P] = fq_pair_se(in, 8 * j + f, p);
      o.proper[j * P + p] = 0;
    }
    return 0;
  }
  // mapQ_p (bwape.c:169-181): the high words' difference as C's uint64
  // subtraction leaves it; only a difference <= s_mm * 10 reaches g_log_n
  const int64_t diff =
      (uint32_t)((uint32_t)(s2 >> 32) - (uint32_t)(o_key >> 32));
  const int n_cap = fq_clamp(subo_n, 0, 255);
  int64_t mapq_p = 0;
  if (o_n == 1) {
    if (s2 == FQ_PAIR_U64MAX)
      mapq_p = 29;
    else if (diff > (int64_t)prm.s_mm * 10)
      mapq_p = 23;
    else {
      mapq_p = diff / 2 - in.g_log_n[n_cap];
      if (mapq_p < 0) mapq_p = 0;
    }
  }
  // the chosen entry of each end
  const int32_t ch_pos[2] = {u_end == 0 ? u_pos : v_pos,
                             u_end == 0 ? v_pos : u_pos};
  // the chosen rows' words (u of end u_end, v of the other)
  const int32_t u_meta = fq_pair_word(in, p, u_end, u_row);
  const int32_t v_meta = fq_pair_word(in, p, 1 - u_end, v_row);
  const int32_t ch_meta[2] = {u_end == 0 ? u_meta : v_meta,
                              u_end == 0 ? v_meta : u_meta};
  int32_t se_pos[2], se_strand[2];
  bool m[2];
  int64_t mq[2], sq[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    se_pos[j] = fq_pair_se(in, 8 * j, p);
    se_strand[j] = fq_pair_se(in, 8 * j + 1, p);
    m[j] = se_pos[j] == ch_pos[j] && se_strand[j] == ((ch_meta[j] >> 18) & 1);
    mq[j] = fq_pair_se(in, 8 * j + 2, p);
    sq[j] = fq_pair_se(in, 8 * j + 3, p);
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
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int32_t mt = ch_meta[j], rst = (mt >> 18) & 1;
    const bool moved = se_pos[j] != ch_pos[j] || se_strand[j] != rst;
    const int32_t vals[7] = {ch_pos[j],
                             rst,
                             (int32_t)nmq[j],
                             (int32_t)nsq[j],
                             mt & 63,
                             (mt >> 6) & 63,
                             (mt >> 12) & 63};
#pragma unroll
    for (int f = 0; f < 7; ++f) {
      const bool take = f == 2 || f == 3 || moved;
      op[(7 * j + f) * P] = take ? vals[f] : fq_pair_se(in, 8 * j + f, p);
    }
    o.proper[j * P + p] = 1;
    chg += moved && (int32_t)nmq[j] > 0;
  }
  return chg;
}
