// Native exact aligner engine: the inexact FM backward search on the
// fastquick_tpu_torch index layout.
//
// This is the production host engine for the search core, implementing
// the same semantics as the Python oracle in align/core.py (score-bucketed
// best-first search with LIFO buckets, seeding lower bounds, gap_shadow,
// top2 cutoffs -- the behavior of the reference's seed aligner,
// libbwa/bwtgap.c:104-264) over OUR index arrays: 2-bit packed BWT words
// with 128-base occ checkpoints and a fully resident suffix array.
// Written from the oracle's specification; the data layout, structures
// and code are this project's own.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__AVX512VL__) && defined(__AVX512VPOPCNTDQ__)
#include <immintrin.h>
#define FQ_SIMD_RANK 1
#endif

namespace {

constexpr int OCC_BLOCK = 128;
constexpr int WPB = 8;  // words per block

// one cache line per 128-base block: checkpoint counts + packed bases
// (bwa's interleaved bwt_t layout, libbwa/bwt.h:56-63 -- one memory
// fetch per rank query instead of two)
struct alignas(64) Block {
  int32_t cnt[4];
  uint32_t w[8];
  int32_t pad[4];
};

struct Dir {
  const uint32_t *words;
  const int32_t *occ;  // (n_blocks+1) x 4
  const int32_t *sa;   // n+1
  int32_t L2[4];
  int32_t primary;
  std::vector<Block> blocks;  // interleaved copy built at aln_create
};

struct Index {
  Dir dir[2];  // 0 = forward, 1 = reverse
  int64_t n;
};

// Optional work counters for tools/prof_aligner.cpp (-DFQ_PROF_COUNTERS);
// noop macros in production builds.  Round-1 findings on the 2M-bp bench
// world: pops ~336/read (32% post-first-hit), pushes ~757/read of which
// only 0.5% are dead (score past the best+s_mm cutoff), occ ~311/read
// (12.7% where only the exact child can survive), and match_exact_alt
// walks ~1300 bases/read -- the single hottest loop after occ itself.
#ifdef FQ_PROF_COUNTERS
struct ProfCounters {
  long long pops = 0, pops_posthit = 0, pushes = 0, pushes_dead = 0,
            occ_calls = 0, occ_dead = 0, exact_alt_steps = 0;
} g_prof;
#define FQ_PROF_INC(x, v) (g_prof.x += (v))
int g_prof_cutoff = 0x7FFFFFFF;
#else
#define FQ_PROF_INC(x, v) ((void)0)
#endif

inline int popcount32(uint32_t x) { return __builtin_popcount(x); }

#ifdef FQ_SIMD_RANK
// prefix masks over a 128-base block as 8x uint32 lanes: entry p selects
// the first p bases (2 bits each, high-first within each word)
struct PrefixMaskTable {
  alignas(32) uint32_t m[129][8];
  PrefixMaskTable() {
    for (int p = 0; p <= 128; ++p)
      for (int wi = 0; wi < 8; ++wi) {
        int pp = p - 16 * wi;
        m[p][wi] = pp >= 16 ? 0xFFFFFFFFu
                            : (pp <= 0 ? 0u : (0xFFFFFFFFu << (32 - 2 * pp)));
      }
  }
};
const PrefixMaskTable kPfx;

inline int hsum256(__m256i v) {
  __m128i s = _mm_add_epi32(_mm256_castsi256_si128(v),
                            _mm256_extracti128_si256(v, 1));
  s = _mm_add_epi32(s, _mm_shuffle_epi32(s, 0x4E));
  s = _mm_add_epi32(s, _mm_shuffle_epi32(s, 0xB1));
  return _mm_cvtsi128_si32(s);
}

// per-lane mask of positions whose 2-bit code equals c (works for A too)
inline __m256i base_match(__m256i W, int c) {
  static const uint32_t pats[4] = {0u, 0x55555555u, 0xAAAAAAAAu,
                                   0xFFFFFFFFu};
  __m256i X = _mm256_xor_si256(W, _mm256_set1_epi32(pats[c]));
  __m256i Y = _mm256_or_si256(X, _mm256_srli_epi32(X, 1));
  return _mm256_andnot_si256(Y, _mm256_set1_epi32(0x55555555));
}

inline int rank1_block(const Block &B, int rem, int c) {
  __m256i W = _mm256_loadu_si256((const __m256i *)B.w);
  __m256i M = _mm256_load_si256((const __m256i *)kPfx.m[rem]);
  return hsum256(_mm256_popcnt_epi32(_mm256_and_si256(base_match(W, c), M)));
}

// C/G/T counts at one prefix; A derived from the total by callers
inline void rank3_block(const Block &B, int rem, int out[3]) {
  __m256i W = _mm256_loadu_si256((const __m256i *)B.w);
  __m256i M = _mm256_load_si256((const __m256i *)kPfx.m[rem]);
  for (int c = 1; c <= 3; ++c)
    out[c - 1] = hsum256(
        _mm256_popcnt_epi32(_mm256_and_si256(base_match(W, c), M)));
}

// C/G/T counts at two prefixes of the same block: the base-match masks
// are shared, only the prefix masks differ
inline void rank3x2_block(const Block &B, int remk, int reml, int outk[3],
                          int outl[3]) {
  __m256i W = _mm256_loadu_si256((const __m256i *)B.w);
  __m256i Mk = _mm256_load_si256((const __m256i *)kPfx.m[remk]);
  __m256i Ml = _mm256_load_si256((const __m256i *)kPfx.m[reml]);
  for (int c = 1; c <= 3; ++c) {
    __m256i Z = base_match(W, c);
    outk[c - 1] = hsum256(_mm256_popcnt_epi32(_mm256_and_si256(Z, Mk)));
    outl[c - 1] = hsum256(_mm256_popcnt_epi32(_mm256_and_si256(Z, Ml)));
  }
}

inline void rank1x2_block(const Block &B, int remk, int reml, int c,
                          int *outk, int *outl) {
  __m256i W = _mm256_loadu_si256((const __m256i *)B.w);
  __m256i Z = base_match(W, c);
  __m256i Mk = _mm256_load_si256((const __m256i *)kPfx.m[remk]);
  __m256i Ml = _mm256_load_si256((const __m256i *)kPfx.m[reml]);
  *outk = hsum256(_mm256_popcnt_epi32(_mm256_and_si256(Z, Mk)));
  *outl = hsum256(_mm256_popcnt_epi32(_mm256_and_si256(Z, Ml)));
}
#endif  // FQ_SIMD_RANK


// count of base c in the first `prefix` (<=32) bases of a 64-bit pack
inline int pair_prefix_count(uint64_t w64, int c, int prefix) {
  static const uint64_t pats[4] = {0x0000000000000000ull,
                                   0x5555555555555555ull,
                                   0xAAAAAAAAAAAAAAAAull,
                                   0xFFFFFFFFFFFFFFFFull};
  uint64_t x = w64 ^ pats[c];
  uint64_t y = x | (x >> 1);
  uint64_t match = ~y & 0x5555555555555555ull;
  uint64_t mask = prefix >= 32
                      ? 0xFFFFFFFFFFFFFFFFull
                      : (prefix <= 0 ? 0ull
                                     : (0xFFFFFFFFFFFFFFFFull
                                        << (64 - 2 * prefix)));
  return __builtin_popcountll(match & mask);
}

// occ over closed rows [0..k] for all four bases: one cache-line fetch
// + 64-bit popcount rank, A-count derived from the total
inline void occ4(const Dir &d, int64_t k, int64_t n, int32_t out[4]) {
  int64_t kk = k + 1;
  int64_t kp = kk - (kk > d.primary ? 1 : 0);
  if (kp < 0) kp = 0;
  if (kp > n) kp = n;
  int64_t block = kp / OCC_BLOCK;
  int rem0 = (int)(kp - block * OCC_BLOCK);
  const Block &B = d.blocks[block];
#ifdef FQ_SIMD_RANK
  int cgt[3];
  rank3_block(B, rem0, cgt);
  int c1 = cgt[0], c2 = cgt[1], c3 = cgt[2];
#else
  int c1 = 0, c2 = 0, c3 = 0;
  int rem = rem0;
  for (int wi = 0; wi < WPB && rem > 0; wi += 2, rem -= 32) {
    uint64_t w64 = ((uint64_t)B.w[wi] << 32) | B.w[wi + 1];
    int p = rem > 32 ? 32 : rem;
    c1 += pair_prefix_count(w64, 1, p);
    c2 += pair_prefix_count(w64, 2, p);
    c3 += pair_prefix_count(w64, 3, p);
  }
#endif
  out[0] = B.cnt[0] + (rem0 - c1 - c2 - c3);
  out[1] = B.cnt[1] + c1;
  out[2] = B.cnt[2] + c2;
  out[3] = B.cnt[3] + c3;
}

// single-base rank: same block walk, one popcount per word pair
inline int32_t occ1(const Dir &d, int64_t k, int64_t n, int c) {
  int64_t kk = k + 1;
  int64_t kp = kk - (kk > d.primary ? 1 : 0);
  if (kp < 0) kp = 0;
  if (kp > n) kp = n;
  int64_t block = kp / OCC_BLOCK;
  int rem = (int)(kp - block * OCC_BLOCK);
  const Block &B = d.blocks[block];
  int cnt = B.cnt[c];
#ifdef FQ_SIMD_RANK
  return cnt + rank1_block(B, rem, c);
#endif
  if (c == 0) {
    // A-count = prefix total - (C+G+T); count non-A directly instead
    int rest = 0, r2 = rem;
    for (int wi = 0; wi < WPB && r2 > 0; wi += 2, r2 -= 32) {
      uint64_t w64 = ((uint64_t)B.w[wi] << 32) | B.w[wi + 1];
      int p = r2 > 32 ? 32 : r2;
      uint64_t y = w64 | (w64 >> 1);  // any set bit pair -> non-A
      uint64_t mask = p >= 32 ? 0xFFFFFFFFFFFFFFFFull
                              : (0xFFFFFFFFFFFFFFFFull << (64 - 2 * p));
      rest += __builtin_popcountll(y & 0x5555555555555555ull & mask);
    }
    return cnt + rem - rest;
  }
  for (int wi = 0; wi < WPB && rem > 0; wi += 2, rem -= 32) {
    uint64_t w64 = ((uint64_t)B.w[wi] << 32) | B.w[wi + 1];
    int p = rem > 32 ? 32 : rem;
    cnt += pair_prefix_count(w64, c, p);
  }
  return cnt;
}

// 2-bit code at (primary-adjusted) BWT position pos
inline int bwt_char(const Dir &d, int64_t pos) {
  const Block &B = d.blocks[pos / OCC_BLOCK];
  int rem = (int)(pos % OCC_BLOCK);
  return (B.w[rem / 16] >> (30 - 2 * (rem % 16))) & 3;
}

inline uint64_t prefix_mask(int p) {
  return p >= 32 ? 0xFFFFFFFFFFFFFFFFull
                 : (0xFFFFFFFFFFFFFFFFull << (64 - 2 * p));
}

// fused single-base rank at two rows sharing one block fetch (the narrow
// phase of width calc / exact extension, where k and l stay together)
inline void occ1x2(const Dir &d, int64_t k, int64_t l, int64_t n, int c,
                   int32_t *ok, int32_t *ol) {
  int64_t kk = k + 1, ll = l + 1;
  int64_t kp = kk - (kk > d.primary ? 1 : 0);
  int64_t lp = ll - (ll > d.primary ? 1 : 0);
  if (kp < 0) kp = 0;
  if (kp > n) kp = n;
  if (lp < 0) lp = 0;
  if (lp > n) lp = n;
  if (kp / OCC_BLOCK != lp / OCC_BLOCK || kp > lp) {
    *ok = occ1(d, k, n, c);
    *ol = occ1(d, l, n, c);
    return;
  }
  int64_t block = kp / OCC_BLOCK;
  int remk = (int)(kp - block * OCC_BLOCK);
  int reml = (int)(lp - block * OCC_BLOCK);
  const Block &B = d.blocks[block];
#ifdef FQ_SIMD_RANK
  int ck, cl;
  rank1x2_block(B, remk, reml, c, &ck, &cl);
  *ok = B.cnt[c] + ck;
  *ol = B.cnt[c] + cl;
#else
  int ck = 0, cl = 0;
  int rem = reml;
  for (int wi = 0; wi < WPB && rem > 0; wi += 2, rem -= 32) {
    uint64_t w64 = ((uint64_t)B.w[wi] << 32) | B.w[wi + 1];
    int pl = rem > 32 ? 32 : rem;
    int pk = remk - (reml - rem);
    if (c == 0) {  // count non-A, derive A from prefix length
      uint64_t y = (w64 | (w64 >> 1)) & 0x5555555555555555ull;
      cl += __builtin_popcountll(y & prefix_mask(pl));
      if (pk > 0)
        ck += __builtin_popcountll(y & prefix_mask(pk > 32 ? 32 : pk));
    } else {
      cl += pair_prefix_count(w64, c, pl);
      if (pk > 0) ck += pair_prefix_count(w64, c, pk > 32 ? 32 : pk);
    }
  }
  if (c == 0) {
    *ok = B.cnt[0] + remk - ck;
    *ol = B.cnt[0] + reml - cl;
  } else {
    *ok = B.cnt[c] + ck;
    *ol = B.cnt[c] + cl;
  }
#endif
}

// fused rank at two rows; when both land in one block (narrow interval,
// the common case late in the search) the cache line and the shared
// prefix are walked once (bwa bwt_2occ4, libbwa/bwt.h:185)
inline void occ4x2(const Dir &d, int64_t k, int64_t l, int64_t n,
                   int32_t ok[4], int32_t ol[4]) {
  int64_t kk = k + 1, ll = l + 1;
  int64_t kp = kk - (kk > d.primary ? 1 : 0);
  int64_t lp = ll - (ll > d.primary ? 1 : 0);
  if (kp < 0) kp = 0;
  if (kp > n) kp = n;
  if (lp < 0) lp = 0;
  if (lp > n) lp = n;
  if (kp / OCC_BLOCK != lp / OCC_BLOCK) {
    occ4(d, k, n, ok);
    occ4(d, l, n, ol);
    return;
  }
  int64_t block = kp / OCC_BLOCK;
  int remk = (int)(kp - block * OCC_BLOCK);
  int reml = (int)(lp - block * OCC_BLOCK);
  if (remk > reml) {  // k <= l normally, but stay safe
    occ4(d, k, n, ok);
    occ4(d, l, n, ol);
    return;
  }
  const Block &B = d.blocks[block];
#ifdef FQ_SIMD_RANK
  int kc[3], lc[3];
  rank3x2_block(B, remk, reml, kc, lc);
  int k1 = kc[0], k2 = kc[1], k3 = kc[2];
  int l1 = lc[0], l2 = lc[1], l3 = lc[2];
#else
  int k1 = 0, k2 = 0, k3 = 0, l1 = 0, l2 = 0, l3 = 0;
  int rem = reml;
  for (int wi = 0; wi < WPB && rem > 0; wi += 2, rem -= 32) {
    uint64_t w64 = ((uint64_t)B.w[wi] << 32) | B.w[wi + 1];
    int pl = rem > 32 ? 32 : rem;
    int pk = remk - (reml - rem);  // k-prefix inside this pair
    l1 += pair_prefix_count(w64, 1, pl);
    l2 += pair_prefix_count(w64, 2, pl);
    l3 += pair_prefix_count(w64, 3, pl);
    if (pk > 0) {
      k1 += pair_prefix_count(w64, 1, pk > 32 ? 32 : pk);
      k2 += pair_prefix_count(w64, 2, pk > 32 ? 32 : pk);
      k3 += pair_prefix_count(w64, 3, pk > 32 ? 32 : pk);
    }
  }
#endif
  ok[0] = B.cnt[0] + (remk - k1 - k2 - k3);
  ok[1] = B.cnt[1] + k1;
  ok[2] = B.cnt[2] + k2;
  ok[3] = B.cnt[3] + k3;
  ol[0] = B.cnt[0] + (reml - l1 - l2 - l3);
  ol[1] = B.cnt[1] + l1;
  ol[2] = B.cnt[2] + l2;
  ol[3] = B.cnt[3] + l3;
}

struct Entry {
  int32_t k, l;
  int32_t info;  // score<<21 | a<<20 | i
  int16_t n_mm, n_gapo, n_gape, state;
  int32_t last_diff_pos;
};

struct Stack {
  std::vector<std::vector<Entry>> slots;
  std::vector<int> counts;
  int best, n_entries, n_buckets;

  void init(int nb) {
    n_buckets = nb;
    slots.assign(nb, {});
    counts.assign(nb, 0);
    best = nb;
    n_entries = 0;
  }
  void reset() {
    std::fill(counts.begin(), counts.end(), 0);
    best = n_buckets;
    n_entries = 0;
  }
  void push(int score, int a, int i, int32_t k, int32_t l, int mm, int go,
            int ge, int state, bool is_diff) {
    auto &b = slots[score];
    int n = counts[score];
    if (n == (int)b.size()) b.push_back(Entry{0, 0, 0, 0, 0, 0, 0, 0});
    Entry &e = b[n];
    e.info = (score << 21) | (a << 20) | i;
    e.k = k;
    e.l = l;
    e.n_mm = (int16_t)mm;
    e.n_gapo = (int16_t)go;
    e.n_gape = (int16_t)ge;
    e.state = (int16_t)state;
    if (is_diff) e.last_diff_pos = i;  // else: slot-persistent stale value
    counts[score] = n + 1;
    ++n_entries;
#ifdef FQ_PROF_COUNTERS
    ++g_prof.pushes;
    if (score > g_prof_cutoff) ++g_prof.pushes_dead;
#endif
    if (best > score) best = score;
  }
  Entry pop() {
    int s = best;
    Entry e = slots[s][--counts[s]];
    --n_entries;
    if (counts[s] == 0 && n_entries) {
      int i = s + 1;
      while (i < n_buckets && counts[i] == 0) ++i;
      best = i;
    } else if (n_entries == 0) {
      best = n_buckets;
    }
    return e;
  }
};

struct Width {
  int32_t w, bid;
};

// one backward step of the width walk; returns the new interval
inline void width_step(const Dir &d, int64_t n, int c, int64_t &k,
                       int64_t &l) {
  if (c < 4) {
    if (k == l) {
      if (k != d.primary && bwt_char(d, k - (k > d.primary)) == c) {
        k = l = d.L2[c] + occ1(d, k - 1, n, c) + 1;
      } else {
        k = 1;
        l = 0;  // dead -> reset by caller
      }
    } else {
      int32_t ok, ol;
      occ1x2(d, k - 1, l, n, c, &ok, &ol);
      k = d.L2[c] + ok + 1;
      l = d.L2[c] + ol;
    }
  }
}

// both directions' width walks in lockstep: the two dependent load
// chains are independent, so interleaving them doubles the memory-level
// parallelism of this latency-bound walk
void cal_width2(const Dir &d0, const Dir &d1, int64_t n, int len,
                const uint8_t *s0, const uint8_t *s1, Width *w0, Width *w1) {
  int64_t k0 = 0, l0 = n, k1 = 0, l1 = n;
  int bid0 = 0, bid1 = 0;
  for (int i = 0; i < len; ++i) {
    int c0 = s0[i], c1 = s1[i];
    width_step(d0, n, c0, k0, l0);
    width_step(d1, n, c1, k1, l1);
    if (k0 > l0 || c0 > 3) {
      k0 = 0;
      l0 = n;
      ++bid0;
    }
    if (k1 > l1 || c1 > 3) {
      k1 = 0;
      l1 = n;
      ++bid1;
    }
    w0[i].w = (int32_t)(l0 - k0 + 1);
    w0[i].bid = bid0;
    w1[i].w = (int32_t)(l1 - k1 + 1);
    w1[i].bid = bid1;
  }
  w0[len].w = 0;
  w0[len].bid = ++bid0;
  w1[len].w = 0;
  w1[len].bid = ++bid1;
}

// A group of reads' width walks interleaved: each chain's rank loads are
// a serial dependency, but chains are independent, so walking 2*G chains
// (G reads x fwd/rev) in lockstep raises memory-level parallelism well
// past the 2-way cal_width2 (the walk is latency-bound, not FLOP-bound).
struct WChain {
  const Dir *d;
  const uint8_t *s;
  int len;
  Width *w;
  int64_t k, l;
  int bid;
};

void cal_width_multi(int64_t n, WChain *ch, int m) {
  int maxlen = 0;
  for (int j = 0; j < m; ++j) {
    ch[j].k = 0;
    ch[j].l = n;
    ch[j].bid = 0;
    if (ch[j].len > maxlen) maxlen = ch[j].len;
  }
  for (int i = 0; i < maxlen; ++i) {
    for (int j = 0; j < m; ++j) {
      WChain &c = ch[j];
      if (i >= c.len) continue;
      int base = c.s[i];
      width_step(*c.d, n, base, c.k, c.l);
      if (c.k > c.l || base > 3) {
        c.k = 0;
        c.l = n;
        ++c.bid;
      }
      c.w[i].w = (int32_t)(c.l - c.k + 1);
      c.w[i].bid = c.bid;
    }
  }
  for (int j = 0; j < m; ++j) {
    ch[j].w[ch[j].len].w = 0;
    ch[j].w[ch[j].len].bid = ch[j].bid + 1;
  }
}

void cal_width(const Dir &d, int64_t n, int len, const uint8_t *s,
               Width *width) {
  int64_t k = 0, l = n;
  int bid = 0;
  for (int i = 0; i < len; ++i) {
    int c = s[i];
    if (c < 4) {
      if (k == l) {
        // single row: it extends iff its own BWT char is c
        if (k != d.primary && bwt_char(d, k - (k > d.primary)) == c) {
          k = l = d.L2[c] + occ1(d, k - 1, n, c) + 1;
        } else {
          k = 1;
          l = 0;  // dead -> reset below
        }
      } else {
        int32_t ok, ol;
        occ1x2(d, k - 1, l, n, c, &ok, &ol);
        k = d.L2[c] + ok + 1;
        l = d.L2[c] + ol;
      }
    }
    if (k > l || c > 3) {
      k = 0;
      l = n;
      ++bid;
    }
    width[i].w = (int32_t)(l - k + 1);
    width[i].bid = bid;
  }
  width[len].w = 0;
  width[len].bid = ++bid;
}

bool match_exact_alt(const Dir &d, int64_t n, int len, const uint8_t *s,
                     int32_t *k0, int32_t *l0) {
  int64_t k = *k0, l = *l0;
  FQ_PROF_INC(exact_alt_steps, len);
  for (int i = len - 1; i >= 0; --i) {
    int c = s[i];
    if (c > 3) return false;
    if (k == l) {
      if (k == d.primary || bwt_char(d, k - (k > d.primary)) != c)
        return false;
      k = l = d.L2[c] + occ1(d, k - 1, n, c) + 1;
      continue;
    }
    int32_t ok, ol;
    occ1x2(d, k - 1, l, n, c, &ok, &ol);
    k = d.L2[c] + ok + 1;
    l = d.L2[c] + ol;
    if (k > l) return false;
  }
  *k0 = (int32_t)k;
  *l0 = (int32_t)l;
  return true;
}

void gap_shadow(int x, int last_diff_pos, int64_t maxv, Width *w) {
  int j = 0;
  for (int i = 0; i < last_diff_pos; ++i) {
    if (w[i].w > x)
      w[i].w -= x;
    else if (w[i].w == x) {
      w[i].bid = 1;
      w[i].w = (int32_t)(maxv - (++j));
    }
  }
}

struct Opt {
  int s_mm, s_gapo, s_gape;
  int max_diff, max_gapo, max_gape;
  int indel_end_skip, max_del_occ, max_entries, max_top2;
  int seed_len, max_seed_diff;
  int mode_gape;  // BWA_MODE_GAPE set
};

inline int aln_score(const Opt &o, int m, int go, int ge) {
  return m * o.s_mm + go * o.s_gapo + ge * o.s_gape;
}

constexpr int STATE_M = 0, STATE_I = 1, STATE_D = 2;

// the inexact search; appends hits (n_mm,n_gapo,n_gape,a,k,l,score) x7
int match_gap(const Index &idx, int len, const uint8_t *seqs[2], Width *w[2],
              Width *seed_w[2], bool use_seed, const Opt &opt, Stack &stack,
              int32_t *out, int out_cap) {
  int best_score = aln_score(opt, opt.max_diff + 1, opt.max_gapo + 1,
                             opt.max_gape + 1);
  int best_diff = opt.max_diff + 1;
  int max_diff = opt.max_diff;
  int best_cnt = 0;
  int n_aln = 0;
  int64_t n = idx.n;

  int n_n = 0;
  for (int j = 0; j < len; ++j)
    if (seqs[0][j] > 3) ++n_n;
  if (n_n > max_diff) return 0;

  stack.reset();
#ifdef FQ_PROF_COUNTERS
  g_prof_cutoff = 0x7FFFFFFF;
#endif
  stack.push(0, 0, len, 0, (int32_t)n, 0, 0, 0, 0, false);
  stack.push(0, 1, len, 0, (int32_t)n, 0, 0, 0, 0, false);

  while (stack.n_entries) {
    if (stack.n_entries > opt.max_entries) break;
    Entry e = stack.pop();
    FQ_PROF_INC(pops, 1);
    FQ_PROF_INC(pops_posthit, n_aln > 0 ? 1 : 0);
    int32_t k = e.k, l = e.l;
    int a = (e.info >> 20) & 1;
    int i = e.info & 0xFFFF;
    int e_score = e.info >> 21;
    if (e_score > best_score + opt.s_mm) break;

    int m = max_diff - (e.n_mm + e.n_gapo);
    if (opt.mode_gape) m -= e.n_gape;
    if (m < 0) continue;
    const Dir &d = idx.dir[1 - a];
    const uint8_t *s = seqs[a];
    Width *width = w[a];
    int m_seed = 0;
    Width *sw = nullptr;
    if (use_seed) {
      sw = seed_w[a];
      m_seed = opt.max_seed_diff - (e.n_mm + e.n_gapo);
      if (opt.mode_gape) m_seed -= e.n_gape;
    }
    if (i > 0 && m < width[i - 1].bid) continue;

    bool hit_found = false;
    if (i == 0) {
      hit_found = true;
    } else if (m == 0 && (e.state == STATE_M || opt.mode_gape ||
                          e.n_gape == opt.max_gape)) {
      if (match_exact_alt(d, n, i, s, &k, &l))
        hit_found = true;
      else
        continue;
    }

    if (hit_found) {
      int score = aln_score(opt, e.n_mm, e.n_gapo, e.n_gape);
      bool do_add = true;
      if (n_aln == 0) {
        best_score = score;
        best_diff = e.n_mm + e.n_gapo;
        if (opt.mode_gape) best_diff += e.n_gape;
        max_diff = best_diff + 1 > opt.max_diff ? opt.max_diff : best_diff + 1;
#ifdef FQ_PROF_COUNTERS
        g_prof_cutoff = best_score + opt.s_mm;
#endif
      }
      if (score == best_score)
        best_cnt += l - k + 1;
      else if (best_cnt > opt.max_top2)
        break;
      if (e.n_gapo) {
        for (int j = 0; j < n_aln; ++j)
          if (out[j * 7 + 4] == k && out[j * 7 + 5] == l) {
            do_add = false;
            break;
          }
      }
      if (do_add) {
        gap_shadow(l - k + 1, e.last_diff_pos, n, width);
        if (n_aln < out_cap) {
          int32_t *r = out + n_aln * 7;
          r[0] = e.n_mm;
          r[1] = e.n_gapo;
          r[2] = e.n_gape;
          r[3] = a;
          r[4] = k;
          r[5] = l;
          r[6] = score;
        }
        ++n_aln;
      }
      continue;
    }

    --i;
#ifdef FQ_PROF_COUNTERS
    ++g_prof.occ_calls;
    if (n_aln > 0) {
      int cut = best_score + opt.s_mm;
      int mm_sc = aln_score(opt, e.n_mm + 1, e.n_gapo, e.n_gape);
      int go_sc = aln_score(opt, e.n_mm, e.n_gapo + 1, e.n_gape);
      int ge_sc = aln_score(opt, e.n_mm, e.n_gapo, e.n_gape + 1);
      bool gap_live = (e.state == STATE_M)
                          ? (e.n_gapo < opt.max_gapo && go_sc <= cut)
                          : (e.n_gape < opt.max_gape && ge_sc <= cut);
      if (mm_sc > cut && !gap_live) ++g_prof.occ_dead;
    }
#endif
    int32_t cnt_k[4], cnt_l[4];
    if (k == l) {
      // single row: only its own BWT char survives any extension; fill
      // the count arrays so the push loops below see dead intervals for
      // the other three bases (kj = lj + 1)
      cnt_k[0] = cnt_k[1] = cnt_k[2] = cnt_k[3] = 1;
      cnt_l[0] = cnt_l[1] = cnt_l[2] = cnt_l[3] = 0;
      if (k != d.primary) {
        int b = bwt_char(d, (int64_t)k - (k > d.primary));
        int32_t ob = occ1(d, (int64_t)k - 1, n, b);
        cnt_k[b] = ob;
        cnt_l[b] = ob + 1;
      }
    } else {
      occ4x2(d, (int64_t)k - 1, l, n, cnt_k, cnt_l);
    }
    int64_t occw = (int64_t)l - k + 1;

    bool allow_diff = true, allow_m = true;
    if (i > 0) {
      int ii = i - (len - opt.seed_len);
      if (width[i - 1].bid > m - 1)
        allow_diff = false;
      else if (width[i - 1].bid == m - 1 && width[i].bid == m - 1 &&
               width[i - 1].w == width[i].w)
        allow_m = false;
      if (sw && ii > 0) {
        if (sw[ii - 1].bid > m_seed - 1)
          allow_diff = false;
        else if (sw[ii - 1].bid == m_seed - 1 && sw[ii].bid == m_seed - 1 &&
                 sw[ii - 1].w == sw[ii].w)
          allow_m = false;
      }
    }

    int tmp = e.n_gapo + e.n_gape;  // no LOGGAP mode
    if (allow_diff && i >= opt.indel_end_skip + tmp &&
        len - i >= opt.indel_end_skip + tmp) {
      if (e.state == STATE_M) {
        if (e.n_gapo < opt.max_gapo) {
          stack.push(aln_score(opt, e.n_mm, e.n_gapo + 1, e.n_gape), a, i, k,
                     l, e.n_mm, e.n_gapo + 1, e.n_gape, STATE_I, true);
          for (int j = 0; j < 4; ++j) {
            int32_t kj = d.L2[j] + cnt_k[j] + 1;
            int32_t lj = d.L2[j] + cnt_l[j];
            if (kj <= lj)
              stack.push(aln_score(opt, e.n_mm, e.n_gapo + 1, e.n_gape), a,
                         i + 1, kj, lj, e.n_mm, e.n_gapo + 1, e.n_gape,
                         STATE_D, true);
          }
        }
      } else if (e.state == STATE_I) {
        if (e.n_gape < opt.max_gape)
          stack.push(aln_score(opt, e.n_mm, e.n_gapo, e.n_gape + 1), a, i, k,
                     l, e.n_mm, e.n_gapo, e.n_gape + 1, STATE_I, true);
      } else if (e.state == STATE_D) {
        if (e.n_gape < opt.max_gape) {
          if (e.n_gapo + e.n_gape < max_diff || occw < opt.max_del_occ) {
            for (int j = 0; j < 4; ++j) {
              int32_t kj = d.L2[j] + cnt_k[j] + 1;
              int32_t lj = d.L2[j] + cnt_l[j];
              if (kj <= lj)
                stack.push(aln_score(opt, e.n_mm, e.n_gapo, e.n_gape + 1), a,
                           i + 1, kj, lj, e.n_mm, e.n_gapo, e.n_gape + 1,
                           STATE_D, true);
            }
          }
        }
      }
    }
    if (allow_diff && allow_m) {
      for (int j = 1; j <= 4; ++j) {
        int c = (s[i] + j) & 3;
        bool is_mm = (j != 4 || s[i] > 3);
        int32_t kj = d.L2[c] + cnt_k[c] + 1;
        int32_t lj = d.L2[c] + cnt_l[c];
        if (kj <= lj)
          stack.push(aln_score(opt, e.n_mm + (is_mm ? 1 : 0), e.n_gapo,
                               e.n_gape),
                     a, i, kj, lj, e.n_mm + (is_mm ? 1 : 0), e.n_gapo,
                     e.n_gape, STATE_M, is_mm);
      }
    } else if (s[i] < 4) {
      int c = s[i] & 3;
      int32_t kj = d.L2[c] + cnt_k[c] + 1;
      int32_t lj = d.L2[c] + cnt_l[c];
      if (kj <= lj)
        stack.push(aln_score(opt, e.n_mm, e.n_gapo, e.n_gape), a, i, kj, lj,
                   e.n_mm, e.n_gapo, e.n_gape, STATE_M, false);
    }
  }
  return n_aln;
}

}  // namespace

extern "C" {

void *aln_create(const uint32_t *words_f, const int32_t *occ_f,
                 const int32_t *sa_f, const int32_t *L2_f, int32_t primary_f,
                 const uint32_t *words_r, const int32_t *occ_r,
                 const int32_t *sa_r, const int32_t *L2_r, int32_t primary_r,
                 int64_t n) {
  Index *idx = new Index();
  idx->n = n;
  idx->dir[0] = Dir{words_f, occ_f, sa_f, {L2_f[0], L2_f[1], L2_f[2], L2_f[3]},
                    primary_f, {}};
  idx->dir[1] = Dir{words_r, occ_r, sa_r, {L2_r[0], L2_r[1], L2_r[2], L2_r[3]},
                    primary_r, {}};
  int64_t n_blocks = n / OCC_BLOCK + 1;
  for (int a = 0; a < 2; ++a) {
    Dir &d = idx->dir[a];
    d.blocks.resize(n_blocks + 1);
    for (int64_t b = 0; b < n_blocks; ++b) {
      Block &bl = d.blocks[b];
      for (int c = 0; c < 4; ++c) bl.cnt[c] = d.occ[b * 4 + c];
      for (int wi = 0; wi < WPB; ++wi) bl.w[wi] = d.words[b * WPB + wi];
    }
  }
  return idx;
}

void aln_destroy(void *h) { delete (Index *)h; }

// seqs: B x 2 x L (reversed read, revcomp read), lens: B.
// out_alns: B x out_cap x 7; out_n: B (clamped to out_cap).
// max_diff per read supplied by caller (fnr table); max_gapo batch-level.
void aln_batch_range(Index *idxp, const uint8_t *seqs, const int32_t *lens,
                     const int32_t *max_diffs, int b0, int b1, int L,
                     Opt opt0, int seed_len, int32_t *out_n,
                     int32_t *out_alns, int out_cap) {
  Index &idx = *idxp;
  Opt opt = opt0;
  int md_max = 0;
  for (int b = b0; b < b1; ++b)
    if (max_diffs[b] > md_max) md_max = max_diffs[b];
  Stack stack;
  stack.init(aln_score(opt, md_max + 1, opt.max_gapo + 1, opt.max_gape + 1)
             + 1);
  // widths for a group of reads computed in one interleaved walk, then
  // the (branchy, per-read) search runs over the precomputed arrays
  constexpr int G = 8;
  std::vector<Width> wbuf((size_t)G * 2 * (L + 1)),
      swbuf((size_t)G * 2 * (seed_len + 1));
  WChain chains[2 * G];
  for (int g0 = b0; g0 < b1; g0 += G) {
    int gn = (g0 + G < b1 ? G : b1 - g0);
    int m = 0, sm = 0;
    WChain schains[2 * G];
    for (int gi = 0; gi < gn; ++gi) {
      int b = g0 + gi;
      int len = lens[b];
      const uint8_t *s0 = seqs + (size_t)b * 2 * L;
      for (int dir = 0; dir < 2; ++dir) {
        Width *w = wbuf.data() + (size_t)(gi * 2 + dir) * (L + 1);
        chains[m++] = {&idx.dir[dir], s0 + dir * L, len, w, 0, 0, 0};
        if (len > seed_len) {
          Width *sw = swbuf.data() + (size_t)(gi * 2 + dir) * (seed_len + 1);
          schains[sm++] = {&idx.dir[dir], s0 + dir * L + (len - seed_len),
                           seed_len, sw, 0, 0, 0};
        }
      }
    }
    cal_width_multi(idx.n, chains, m);
    if (sm) cal_width_multi(idx.n, schains, sm);
    for (int gi = 0; gi < gn; ++gi) {
      int b = g0 + gi;
      int len = lens[b];
      const uint8_t *s0 = seqs + (size_t)b * 2 * L;
      const uint8_t *ss[2] = {s0, s0 + L};
      opt.max_diff = max_diffs[b];
      opt.seed_len = seed_len < len ? seed_len : 0x7FFFFFFF;
      Width *ws[2] = {wbuf.data() + (size_t)(gi * 2) * (L + 1),
                      wbuf.data() + (size_t)(gi * 2 + 1) * (L + 1)};
      Width *sws[2] = {swbuf.data() + (size_t)(gi * 2) * (seed_len + 1),
                       swbuf.data() + (size_t)(gi * 2 + 1) * (seed_len + 1)};
      bool use_seed = len > seed_len;
      int nal = match_gap(idx, len, ss, ws, sws, use_seed, opt, stack,
                          out_alns + (size_t)b * out_cap * 7, out_cap);
      // -1 signals hit-list overflow: caller must redo this read with the
      // unbounded engine (truncation would also skew the gapped-hit dedup)
      out_n[b] = nal > out_cap ? -1 : nal;
    }
  }
}

void aln_batch(void *h, const uint8_t *seqs, const int32_t *lens,
               const int32_t *max_diffs, int B, int L, int s_mm, int s_gapo,
               int s_gape, int max_gapo, int max_gape, int indel_end_skip,
               int max_del_occ, int max_entries, int max_top2, int seed_len,
               int max_seed_diff, int32_t *out_n, int32_t *out_alns,
               int out_cap) {
  Index *idx = (Index *)h;
  Opt opt{s_mm, s_gapo, s_gape, 0, max_gapo, max_gape, indel_end_skip,
          max_del_occ, max_entries, max_top2, seed_len, max_seed_diff, 1};
  unsigned nt = std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if ((int)nt > B) nt = B;
  if (nt <= 1) {
    aln_batch_range(idx, seqs, lens, max_diffs, 0, B, L, opt, seed_len,
                    out_n, out_alns, out_cap);
    return;
  }
  std::vector<std::thread> threads;
  int grain = (B + nt - 1) / nt;
  for (unsigned t = 0; t < nt; ++t) {
    int b0 = t * grain;
    int b1 = b0 + grain < B ? b0 + grain : B;
    if (b0 >= b1) break;
    threads.emplace_back(aln_batch_range, idx, seqs, lens, max_diffs, b0, b1,
                         L, opt, seed_len, out_n, out_alns, out_cap);
  }
  for (auto &th : threads) th.join();
}

}  // extern "C"
