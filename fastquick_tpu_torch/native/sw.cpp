// Native banded global + local DP aligners.
//
// C++ port of this project's align/dp.py (itself the behavioral
// equivalent of stdaln's aln_global_core / aln_local_core with
// aln_param_bwa scoring and set_M/set_I/set_D tie-breaking).  Used for
// gapped refinement and mate-rescue SW where the Python DP is too slow;
// results are differential-tested equal to dp.py.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#ifdef __AVX512F__
#include <immintrin.h>
#define FQ_SIMD_SW 1
#endif

namespace {

constexpr int GAP_OPEN = 26, GAP_EXT = 9, GAP_END = 5, BAND = 50;
constexpr int64_t NEG = -1073741823;  // MINOR_INF
constexpr int FROM_M = 0, FROM_I = 1, FROM_D = 2, FROM_S = 3;

inline int score_of(uint8_t a, uint8_t b) {
  if (a > 3 || b > 3) return -13;
  return a == b ? 11 : -19;
}

struct GlobalResult {
  int64_t score;
  // path stored end->begin as (ctype, i, j) triples
  std::vector<int> ctypes, pis, pjs;
};

// mirror of dp.aln_global_core (banded, gap_end at edges)
GlobalResult global_core(const uint8_t *seq1, int len1, const uint8_t *seq2,
                         int len2, int band) {
  GlobalResult res{0, {}, {}, {}};
  if (len1 == 0 || len2 == 0) return res;
  int b1, b2;
  if (len1 > len2) {
    b1 = len1 - len2 + band;
    b2 = band;
  } else {
    b1 = band;
    b2 = len2 - len1 + band;
  }
  if (b1 > len1) b1 = len1;
  if (b2 > len2) b2 = len2;

  size_t W = (size_t)(len1 + 1);
  std::vector<int64_t> M((len2 + 1) * W, NEG), I((len2 + 1) * W, NEG),
      D((len2 + 1) * W, NEG);
  std::vector<int8_t> Mt((len2 + 1) * W, 0), It((len2 + 1) * W, 0),
      Dt((len2 + 1) * W, 0);
#define AT(arr, j, i) arr[(size_t)(j)*W + (i)]

  AT(M, 0, 0) = 0;
  for (int i = 1; i < b1; ++i) {
    int64_t pm = AT(M, 0, i - 1), pd = AT(D, 0, i - 1);
    if (pm - GAP_OPEN > pd) {
      AT(Dt, 0, i) = FROM_M;
      AT(D, 0, i) = pm - GAP_OPEN - GAP_END;
    } else {
      AT(Dt, 0, i) = FROM_D;
      AT(D, 0, i) = pd - GAP_END;
    }
  }
  for (int j = 1; j <= len2; ++j) {
    int lo = j - b2 > 0 ? j - b2 : 0;
    int hi = j + b1 - 1 < len1 ? j + b1 - 1 : len1;
    if (lo == 0) {
      int64_t pm = AT(M, j - 1, 0), pi = AT(I, j - 1, 0);
      if (pm - GAP_OPEN > pi) {
        AT(It, j, 0) = FROM_M;
        AT(I, j, 0) = pm - GAP_OPEN - GAP_END;
      } else {
        AT(It, j, 0) = FROM_I;
        AT(I, j, 0) = pi - GAP_END;
      }
    }
    int start = lo > 0 ? lo : 1;
    for (int i = start; i <= hi; ++i) {
      int64_t pm = AT(M, j - 1, i - 1), pi = AT(I, j - 1, i - 1),
              pd = AT(D, j - 1, i - 1);
      int sc = score_of(seq1[i - 1], seq2[j - 1]);
      if (pm >= pi) {
        if (pm >= pd) {
          AT(M, j, i) = pm + sc;
          AT(Mt, j, i) = FROM_M;
        } else {
          AT(M, j, i) = pd + sc;
          AT(Mt, j, i) = FROM_D;
        }
      } else {
        if (pi > pd) {
          AT(M, j, i) = pi + sc;
          AT(Mt, j, i) = FROM_I;
        } else {
          AT(M, j, i) = pd + sc;
          AT(Mt, j, i) = FROM_D;
        }
      }
      // vertical I
      bool at_right_edge = (i == hi && i != len1);
      bool use_end = (i == len1);
      pm = AT(M, j - 1, i);
      pi = AT(I, j - 1, i);
      if (at_right_edge) {
        AT(I, j, i) = NEG;
      } else if (use_end) {
        if (pm - GAP_OPEN > pi) {
          AT(It, j, i) = FROM_M;
          AT(I, j, i) = pm - GAP_OPEN - GAP_END;
        } else {
          AT(It, j, i) = FROM_I;
          AT(I, j, i) = pi - GAP_END;
        }
      } else {
        if (pm - GAP_OPEN > pi) {
          AT(It, j, i) = FROM_M;
          AT(I, j, i) = pm - GAP_OPEN - GAP_EXT;
        } else {
          AT(It, j, i) = FROM_I;
          AT(I, j, i) = pi - GAP_EXT;
        }
      }
      // horizontal D
      pm = AT(M, j, i - 1);
      int64_t pd2 = AT(D, j, i - 1);
      if (j == len2) {
        if (pm - GAP_OPEN > pd2) {
          AT(Dt, j, i) = FROM_M;
          AT(D, j, i) = pm - GAP_OPEN - GAP_END;
        } else {
          AT(Dt, j, i) = FROM_D;
          AT(D, j, i) = pd2 - GAP_END;
        }
      } else {
        if (pm - GAP_OPEN > pd2) {
          AT(Dt, j, i) = FROM_M;
          AT(D, j, i) = pm - GAP_OPEN - GAP_EXT;
        } else {
          AT(Dt, j, i) = FROM_D;
          AT(D, j, i) = pd2 - GAP_EXT;
        }
      }
    }
  }

  int i = len1, j = len2;
  int64_t mx = AT(M, j, i);
  int8_t typ = AT(Mt, j, i);
  int ctype = FROM_M;
  if (AT(I, j, i) > mx) {
    mx = AT(I, j, i);
    typ = AT(It, j, i);
    ctype = FROM_I;
  }
  if (AT(D, j, i) > mx) {
    mx = AT(D, j, i);
    typ = AT(Dt, j, i);
    ctype = FROM_D;
  }
  res.score = mx;
  res.ctypes.push_back(ctype);
  res.pis.push_back(i);
  res.pjs.push_back(j);
  while (i || j) {
    if (ctype == FROM_M) {
      --i;
      --j;
    } else if (ctype == FROM_I) {
      --j;
    } else {
      --i;
    }
    ctype = typ;
    if (ctype == FROM_M)
      typ = AT(Mt, j, i);
    else if (ctype == FROM_I)
      typ = AT(It, j, i);
    else
      typ = AT(Dt, j, i);
    res.ctypes.push_back(ctype);
    res.pis.push_back(i);
    res.pjs.push_back(j);
  }
  // drop final sentinel (path_len = count-1 like the C/python versions)
  res.ctypes.pop_back();
  res.pis.pop_back();
  res.pjs.pop_back();
#undef AT
  return res;
}

int path_to_cigar(const GlobalResult &r, uint32_t *out, int cap) {
  if (r.ctypes.empty()) return 0;
  // path is end->begin; cigar runs begin->end
  std::vector<uint32_t> ops;
  int last = r.ctypes[0], n = 1;
  for (size_t k = 1; k < r.ctypes.size(); ++k) {
    if (r.ctypes[k] == last)
      ++n;
    else {
      ops.push_back(((uint32_t)last << 28) | n);
      last = r.ctypes[k];
      n = 1;
    }
  }
  ops.push_back(((uint32_t)last << 28) | n);
  int cnt = (int)ops.size();
  if (cnt > cap) return -1;
  for (int k = 0; k < cnt; ++k) out[k] = ops[cnt - 1 - k];
  return cnt;
}

// forward local pass of dp.aln_local_core (C freeze-F semantics)
void local_forward(const uint8_t *s1, int n1, const uint8_t *s2, int n2,
                   int64_t *best, int *bi, int *bj) {
  std::vector<int64_t> h_prev(n1 + 1, 0), e_prev(n1 + 1, 0), h_curr(n1 + 1, 0),
      e_curr(n1 + 1, 0);
  *best = 0;
  *bi = *bj = 0;
  for (int j = 1; j <= n2; ++j) {
    int64_t f = 0;
    std::fill(h_curr.begin(), h_curr.end(), 0);
    std::fill(e_curr.begin(), e_curr.end(), 0);
    for (int i = 1; i <= n1; ++i) {
      int64_t h = h_prev[i - 1] + score_of(s1[i - 1], s2[j - 1]);
      if (h < 0) h = 0;
      if (h_curr[i - 1] > 0) {
        int64_t cand = h_curr[i - 1] - (GAP_OPEN + GAP_EXT);
        f = (f - GAP_EXT > cand) ? f - GAP_EXT : cand;
        if (h < f) h = f;
      }
      int64_t e = e_prev[i] - GAP_EXT;
      int64_t cand2 = h_prev[i] - (GAP_OPEN + GAP_EXT);
      if (cand2 > e) e = cand2;
      if (e < 0) e = 0;
      if (h < e) h = e;
      h_curr[i] = h;
      e_curr[i] = e;
      if (h > *best) {
        *best = h;
        *bi = i;
        *bj = j;
      }
    }
    h_prev.swap(h_curr);
    e_prev.swap(e_curr);
  }
}

#ifdef FQ_SIMD_SW
// 16 independent local_forward DPs in int32 lanes over lane-major
// (transposed) inputs.  Every lane executes exactly the scalar
// recurrence -- including the freeze-F gate and the strict-greater
// (j-outer, i-inner) argmax -- so results are bit-identical per job.
// Scores are bounded by 11*q_len (< 2^31), so int32 lanes are exact.
void local_forward16(const uint8_t *ref_t, const int32_t *n1,
                     const uint8_t *q_t, const int32_t *n2, int max_n1,
                     int max_n2, int64_t *best, int *bi, int *bj,
                     std::vector<int32_t> &hbuf, std::vector<int32_t> &ebuf) {
  const __m512i zero = _mm512_setzero_si512();
  const __m512i v11 = _mm512_set1_epi32(11);
  const __m512i vm19 = _mm512_set1_epi32(-19);
  const __m512i vm13 = _mm512_set1_epi32(-13);
  const __m512i v3 = _mm512_set1_epi32(3);
  const __m512i vqr = _mm512_set1_epi32(GAP_OPEN + GAP_EXT);
  const __m512i vge = _mm512_set1_epi32(GAP_EXT);
  const __m512i n1v = _mm512_loadu_si512(n1);
  const __m512i n2v = _mm512_loadu_si512(n2);
  size_t W = (size_t)(max_n1 + 1) * 16;
  hbuf.assign(2 * W, 0);
  ebuf.assign(2 * W, 0);
  int32_t *h_prev = hbuf.data(), *h_curr = hbuf.data() + W;
  int32_t *e_prev = ebuf.data(), *e_curr = ebuf.data() + W;
  __m512i bestv = zero, biv = zero, bjv = zero;
  for (int j = 1; j <= max_n2; ++j) {
    __m512i qb = _mm512_cvtepu8_epi32(
        _mm_loadu_si128((const __m128i *)(q_t + (size_t)(j - 1) * 16)));
    __m512i f = zero;
    const __m512i jv = _mm512_set1_epi32(j);
    const __mmask16 jin = _mm512_cmple_epi32_mask(jv, n2v);
    _mm512_storeu_si512(h_curr, zero);
    _mm512_storeu_si512(e_curr, zero);
    for (int i = 1; i <= max_n1; ++i) {
      __m512i rb = _mm512_cvtepu8_epi32(
          _mm_loadu_si128((const __m128i *)(ref_t + (size_t)(i - 1) * 16)));
      __mmask16 anyn = _kor_mask16(_mm512_cmpgt_epi32_mask(rb, v3),
                                   _mm512_cmpgt_epi32_mask(qb, v3));
      __mmask16 eq = _mm512_cmpeq_epi32_mask(rb, qb);
      __m512i sc = _mm512_mask_blend_epi32(eq, vm19, v11);
      sc = _mm512_mask_blend_epi32(anyn, sc, vm13);
      __m512i h = _mm512_add_epi32(
          _mm512_loadu_si512(h_prev + (size_t)(i - 1) * 16), sc);
      h = _mm512_max_epi32(h, zero);
      __m512i hc_im1 = _mm512_loadu_si512(h_curr + (size_t)(i - 1) * 16);
      // freeze-F: lanes with h_curr[i-1] <= 0 keep f unchanged/unapplied
      __mmask16 gate = _mm512_cmpgt_epi32_mask(hc_im1, zero);
      __m512i fnew = _mm512_max_epi32(_mm512_sub_epi32(f, vge),
                                      _mm512_sub_epi32(hc_im1, vqr));
      f = _mm512_mask_blend_epi32(gate, f, fnew);
      h = _mm512_mask_max_epi32(h, gate, h, f);
      __m512i e = _mm512_max_epi32(
          _mm512_sub_epi32(_mm512_loadu_si512(e_prev + (size_t)i * 16), vge),
          _mm512_sub_epi32(_mm512_loadu_si512(h_prev + (size_t)i * 16), vqr));
      e = _mm512_max_epi32(e, zero);
      h = _mm512_max_epi32(h, e);
      _mm512_storeu_si512(h_curr + (size_t)i * 16, h);
      _mm512_storeu_si512(e_curr + (size_t)i * 16, e);
      const __m512i iv = _mm512_set1_epi32(i);
      __mmask16 upd = _kand_mask16(
          _kand_mask16(_mm512_cmpgt_epi32_mask(h, bestv), jin),
          _mm512_cmple_epi32_mask(iv, n1v));
      bestv = _mm512_mask_blend_epi32(upd, bestv, h);
      biv = _mm512_mask_blend_epi32(upd, biv, iv);
      bjv = _mm512_mask_blend_epi32(upd, bjv, jv);
    }
    std::swap(h_prev, h_curr);
    std::swap(e_prev, e_curr);
  }
  alignas(64) int32_t tb[16], ti[16], tj[16];
  _mm512_store_si512(tb, bestv);
  _mm512_store_si512(ti, biv);
  _mm512_store_si512(tj, bjv);
  for (int l = 0; l < 16; ++l) {
    best[l] = tb[l];
    bi[l] = ti[l];
    bj[l] = tj[l];
  }
}
#endif  // FQ_SIMD_SW

}  // namespace

extern "C" {

// Banded global alignment; returns score; cigar as (op<<28|len), -1 cap.
long long sw_global(const uint8_t *ref, int rl, const uint8_t *query, int ql,
                    uint32_t *cigar_out, int cap, int *n_cigar) {
  GlobalResult r = global_core(ref, rl, query, ql, BAND);
  *n_cigar = path_to_cigar(r, cigar_out, cap);
  return (long long)r.score;
}

// Local alignment (mate rescue): score; coords[6] = 1-based start_i,
// start_j, end_i, end_j, plus the region path's begin-entry (i0, j0)
// (needed for bwa_sw_core's coordinate math); region path cigar.
// Score < thres or no match -> n_cigar = 0.
long long sw_local(const uint8_t *ref, int rl, const uint8_t *query, int ql,
                   int thres, int *coords, uint32_t *cigar_out, int cap,
                   int *n_cigar) {
  *n_cigar = 0;
  for (int k = 0; k < 6; ++k) coords[k] = 0;
  if (rl == 0 || ql == 0) return -1;
  // Exact-occurrence fast path.  A full-length exact match scores
  // 11*ql, the unique maximum (any mismatch/gap path scores less, and
  // rows j < ql are bounded by 11*j), so the forward pass's
  // strict-greater argmax ends at the LEFTMOST occurrence (end row
  // j == ql), the reverse pass spans exactly the match, and the global
  // traceback is the pure diagonal.  memmem reproduces all of it
  // without the three O(rl*ql) DP passes.  Codes > 3 score -13 even
  // against themselves, so the path requires an N-free query (byte
  // equality then implies an N-free window too).
  if (ql <= rl && thres <= 11 * ql) {
    bool has_n = false;
    for (int z = 0; z < ql; ++z)
      if (query[z] > 3) {
        has_n = true;
        break;
      }
    if (!has_n) {
      const void *hit = memmem(ref, (size_t)rl, query, (size_t)ql);
      if (hit) {
        int p = (int)((const uint8_t *)hit - ref);
        coords[0] = p + 1;
        coords[1] = 1;
        coords[2] = p + ql;
        coords[3] = ql;
        coords[4] = 1;
        coords[5] = 1;
        if (cap >= 1) {
          cigar_out[0] = ((uint32_t)FROM_M << 28) | (uint32_t)ql;
          *n_cigar = 1;
        } else {
          *n_cigar = -1;
        }
        return 11LL * ql;
      }
    }
  }
  int64_t score_f;
  int end_i, end_j;
  local_forward(ref, rl, query, ql, &score_f, &end_i, &end_j);
  coords[2] = end_i;
  coords[3] = end_j;
  if (score_f < thres || end_i == 0 || end_j == 0) return (long long)score_f;
  std::vector<uint8_t> rr1(ref, ref + end_i), rr2(query, query + end_j);
  std::reverse(rr1.begin(), rr1.end());
  std::reverse(rr2.begin(), rr2.end());
  int64_t score_r;
  int ri, rj;
  local_forward(rr1.data(), end_i, rr2.data(), end_j, &score_r, &ri, &rj);
  int start_i = end_i - ri + 1, start_j = end_j - rj + 1;
  coords[0] = start_i;
  coords[1] = start_j;
  GlobalResult g = global_core(ref + start_i - 1, end_i - start_i + 1,
                               query + start_j - 1, end_j - start_j + 1, BAND);
  if (!g.pis.empty()) {
    coords[4] = g.pis.back();
    coords[5] = g.pjs.back();
  }
  *n_cigar = path_to_cigar(g, cigar_out, cap);
  return (long long)score_f;
}

// Batched mate-rescue local SW: n jobs, each ref/query given as
// (offset, len) into the concatenated byte buffers.  Outputs per job:
// scores[i], coords[6*i..], cigars[i*cig_cap..] with n_cigars[i]
// entries.  Runs on nthreads std::threads (jobs are independent).
void sw_local_batch(const uint8_t *refs, const int64_t *ref_off,
                    const int32_t *ref_len, const uint8_t *queries,
                    const int64_t *q_off, const int32_t *q_len, int n,
                    int thres, long long *scores, int *coords,
                    uint32_t *cigars, int cig_cap, int *n_cigars,
                    int nthreads) {
  std::atomic<int> next(0);
#ifdef FQ_SIMD_SW
  // groups of 16 jobs: exact-occurrence prescan, then the forward and
  // reverse local passes run 16-wide (lane results == scalar sw_local),
  // and only the small banded global traceback stays per job
  auto work = [&]() {
    std::vector<int32_t> hbuf, ebuf;
    std::vector<uint8_t> ref_t, q_t;
    for (;;) {
      int g0 = next.fetch_add(16);
      if (g0 >= n) break;
      int g1 = std::min(n, g0 + 16);
      int todo[16], m = 0;
      for (int i = g0; i < g1; ++i) {
        n_cigars[i] = 0;
        for (int k = 0; k < 6; ++k) coords[6 * i + k] = 0;
        int rl = ref_len[i], ql = q_len[i];
        const uint8_t *ref = refs + ref_off[i];
        const uint8_t *q = queries + q_off[i];
        if (rl == 0 || ql == 0) {
          scores[i] = -1;
          continue;
        }
        if (ql <= rl && thres <= 11 * ql && !memchr(q, 4, ql)) {
          const void *hit = memmem(ref, (size_t)rl, q, (size_t)ql);
          if (hit) {
            int p = (int)((const uint8_t *)hit - ref);
            int *c = coords + 6 * i;
            c[0] = p + 1;
            c[1] = 1;
            c[2] = p + ql;
            c[3] = ql;
            c[4] = 1;
            c[5] = 1;
            if (cig_cap >= 1) {
              cigars[(size_t)i * cig_cap] =
                  ((uint32_t)FROM_M << 28) | (uint32_t)ql;
              n_cigars[i] = 1;
            } else {
              n_cigars[i] = -1;
            }
            scores[i] = 11LL * ql;
            continue;
          }
        }
        todo[m++] = i;
      }
      if (!m) continue;
      // ---- forward pass, 16-wide over transposed inputs ----
      alignas(64) int32_t n1[16] = {0}, n2[16] = {0};
      int max_n1 = 0, max_n2 = 0;
      for (int l = 0; l < m; ++l) {
        n1[l] = ref_len[todo[l]];
        n2[l] = q_len[todo[l]];
        if (n1[l] > max_n1) max_n1 = n1[l];
        if (n2[l] > max_n2) max_n2 = n2[l];
      }
      ref_t.assign((size_t)max_n1 * 16, 4);
      q_t.assign((size_t)max_n2 * 16, 4);
      for (int l = 0; l < m; ++l) {
        const uint8_t *ref = refs + ref_off[todo[l]];
        const uint8_t *q = queries + q_off[todo[l]];
        for (int i = 0; i < n1[l]; ++i) ref_t[(size_t)i * 16 + l] = ref[i];
        for (int j = 0; j < n2[l]; ++j) q_t[(size_t)j * 16 + l] = q[j];
      }
      int64_t best[16];
      int bi[16], bj[16];
      local_forward16(ref_t.data(), n1, q_t.data(), n2, max_n1, max_n2, best,
                      bi, bj, hbuf, ebuf);
      // ---- select jobs that pass, queue the reverse pass ----
      int rtodo[16], rm = 0;
      for (int l = 0; l < m; ++l) {
        int i = todo[l];
        scores[i] = best[l];
        coords[6 * i + 2] = bi[l];
        coords[6 * i + 3] = bj[l];
        if (best[l] < thres || bi[l] == 0 || bj[l] == 0) continue;
        rtodo[rm] = l;
        ++rm;
      }
      if (!rm) continue;
      alignas(64) int32_t rn1[16] = {0}, rn2[16] = {0};
      int rmax1 = 0, rmax2 = 0;
      for (int s = 0; s < rm; ++s) {
        int l = rtodo[s];
        rn1[s] = bi[l];
        rn2[s] = bj[l];
        if (rn1[s] > rmax1) rmax1 = rn1[s];
        if (rn2[s] > rmax2) rmax2 = rn2[s];
      }
      ref_t.assign((size_t)rmax1 * 16, 4);
      q_t.assign((size_t)rmax2 * 16, 4);
      for (int s = 0; s < rm; ++s) {
        int l = rtodo[s];
        const uint8_t *ref = refs + ref_off[todo[l]];
        const uint8_t *q = queries + q_off[todo[l]];
        for (int i = 0; i < rn1[s]; ++i)  // reversed prefix of length end_i
          ref_t[(size_t)i * 16 + s] = ref[rn1[s] - 1 - i];
        for (int j = 0; j < rn2[s]; ++j)
          q_t[(size_t)j * 16 + s] = q[rn2[s] - 1 - j];
      }
      int64_t rbest[16];
      int ri[16], rj[16];
      local_forward16(ref_t.data(), rn1, q_t.data(), rn2, rmax1, rmax2, rbest,
                      ri, rj, hbuf, ebuf);
      // ---- banded global traceback per passing job (small region) ----
      for (int s = 0; s < rm; ++s) {
        int l = rtodo[s];
        int i = todo[l];
        int end_i = bi[l], end_j = bj[l];
        int start_i = end_i - ri[s] + 1, start_j = end_j - rj[s] + 1;
        int *c = coords + 6 * i;
        c[0] = start_i;
        c[1] = start_j;
        const uint8_t *ref = refs + ref_off[i];
        const uint8_t *q = queries + q_off[i];
        GlobalResult g =
            global_core(ref + start_i - 1, end_i - start_i + 1,
                        q + start_j - 1, end_j - start_j + 1, BAND);
        if (!g.pis.empty()) {
          c[4] = g.pis.back();
          c[5] = g.pjs.back();
        }
        n_cigars[i] =
            path_to_cigar(g, cigars + (size_t)i * cig_cap, cig_cap);
      }
    }
  };
#else
  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      scores[i] = sw_local(refs + ref_off[i], ref_len[i], queries + q_off[i],
                           q_len[i], thres, coords + 6 * i,
                           cigars + (size_t)i * cig_cap, cig_cap,
                           n_cigars + i);
    }
  };
#endif
  if (nthreads <= 1) {
    work();
    return;
  }
  std::vector<std::thread> ts;
  for (int t = 0; t < nthreads - 1; ++t) ts.emplace_back(work);
  work();
  for (auto &t : ts) t.join();
}

// Set bit k (byte k>>3, bit k&7) for every key: the k-mer filter's
// dense-bitmap construction (BwtIndexer.cpp rollhash dump layout).
// ~100x faster than np.bitwise_or.at.
void set_bits(uint8_t *bitmap, const uint32_t *keys, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t k = keys[i];
    bitmap[k >> 3] |= (uint8_t)(1u << (k & 7));
  }
}

// Same for the device layout: uint32 words, bit k at word k>>5.
void set_bits32(uint32_t *bitmap, const uint32_t *keys, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t k = keys[i];
    bitmap[k >> 5] |= (1u << (k & 31));
  }
}

// MD string + NM count (bwa_cal_md1, libbwa/bwase.c:234-296).
// cigar: (op<<28|len) with FROM_* codes, n_cigar 0 = gapless.
// Returns NM; writes NUL-terminated MD into md_out (cap bytes; returns
// -1 if it would overflow).
int md_nm(const uint32_t *cigar, int n_cigar, int len, long long pos,
          const uint8_t *seq, const uint8_t *text, long long l_pac,
          char *md_out, int cap) {
  static const char *ACGTN = "ACGTN";
  int nm = 0, u = 0;
  long long x = pos;
  int y = 0;
  int o = 0;
#define PUTI(v)                                        \
  do {                                                 \
    char tmp[12];                                      \
    int tn = snprintf(tmp, sizeof tmp, "%d", (v));     \
    if (o + tn + 1 > cap) return -1;                   \
    memcpy(md_out + o, tmp, tn);                       \
    o += tn;                                           \
  } while (0)
#define PUTC(c)                  \
  do {                           \
    if (o + 2 > cap) return -1;  \
    md_out[o++] = (c);           \
  } while (0)
  if (n_cigar > 0) {
    for (int k = 0; k < n_cigar; ++k) {
      int op = cigar[k] >> 28;
      int ln = cigar[k] & 0x0FFFFFFF;
      if (op == FROM_M) {
        for (int z = 0; z < ln && x + z < l_pac; ++z) {
          int c = text[x + z];
          if (c > 3 || seq[y + z] > 3 || c != seq[y + z]) {
            PUTI(u);
            PUTC(ACGTN[c]);
            ++nm;
            u = 0;
          } else
            ++u;
        }
        x += ln;
        y += ln;
      } else if (op == FROM_I || op == FROM_S) {
        y += ln;
        if (op == FROM_I) nm += ln;
      } else if (op == FROM_D) {
        PUTI(u);
        PUTC('^');
        for (int z = 0; z < ln && x + z < l_pac; ++z)
          PUTC("ACGT"[text[x + z]]);
        u = 0;
        x += ln;
        nm += ln;
      }
    }
  } else {
    for (int z = 0; z < len; ++z) {
      int c = x + z < l_pac ? text[x + z] : 4;
      if (c > 3 || seq[z] > 3 || c != seq[z]) {
        PUTI(u);
        PUTC(ACGTN[c]);
        ++nm;
        u = 0;
      } else
        ++u;
    }
  }
  PUTI(u);
  md_out[o] = 0;
  return nm;
#undef PUTI
#undef PUTC
}

// One call for a whole batch's MD/NM (bwa_refine_gapped's per-read
// bwa_cal_md1 loop): flattened cigars/seqs with per-read offsets, MD
// strings written NUL-terminated at fixed stride.  Removes the ~5us/read
// Python+ctypes marshalling and keeps the loop off the GIL.
void md_nm_batch(const uint32_t *cig, const int64_t *cig_off,
                 const int32_t *cig_n, const uint8_t *seqs,
                 const int64_t *seq_off, const int32_t *lens,
                 const int64_t *poses, const uint8_t *text, long long l_pac,
                 char *md_out, int stride, int32_t *nm_out, int n) {
  for (int i = 0; i < n; ++i)
    nm_out[i] = md_nm(cig + cig_off[i], cig_n[i], lens[i], poses[i],
                      seqs + seq_off[i], text, l_pac, md_out + (size_t)i * stride,
                      stride);
}

}  // extern "C"
