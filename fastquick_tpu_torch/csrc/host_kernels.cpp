// Host (g++) build of the kernels' bodies, for the CPU tests: the same
// width_unit / fq_resident_read / fq_scan_lane / sw_lane_step code that
// nvcc compiles into width.cu, search.cu, scan.cu and sw.cu, with the
// kernels' argument layouts and their order of evaluation emulated
// serially.  Never used on the product path.
#include <algorithm>
#include <vector>

#include "search_body.cuh"
#include "sw_body.cuh"
#include "width_body.cuh"

extern "C" int fq_width_host(const int32_t* tab, const int32_t* fm_hp,
                             const uint8_t* units, const int32_t* sel, int M,
                             int L, int32_t* w, int32_t* bid) {
  const FmView fm = fm_view(tab, fm_hp);
  for (int m = 0; m < M; ++m) {
    const int64_t off = (int64_t)m * L;
    width_unit(fm, sel[m], units + off, L, w + off, bid + off);
  }
  return 0;
}

// The resident kernel's reads in the order order[0..N), on kThreads
// workspaces taken in turn, their bucket heads interleaved as in the
// kernel's shared memory; each workspace is reused from read to read
// without clearing.
extern "C" int fq_search_host(const int32_t* tab, const int32_t* fm_hp,
                              const int32_t* sp, const uint8_t* seqs,
                              const int32_t* lens, const int32_t* md,
                              const int32_t* use_seed, const int32_t* n_n,
                              int N, int32_t* widths, const int32_t* seed_w,
                              const int32_t* order, int32_t* alns,
                              int32_t* n_aln, int32_t* fb, int32_t* steps,
                              int32_t* hwm) {
  const int kThreads = 3;
  const FmView fm = fm_view(tab, fm_hp);
  const SearchParams P = search_params(sp);
  std::vector<FqSlot> pool((size_t)P.NP * kThreads);
  std::vector<uint16_t> freel((size_t)P.NP * kThreads);
  std::vector<int16_t> heads(FQ_NBUCK * kThreads);
  const FqChunk ck = {seqs, lens, md, use_seed, n_n, N, widths, seed_w};
  const FqOut out = {alns, n_aln, fb, steps, hwm};
  for (int x = 0; x < N; ++x) {
    const int t = x % kThreads;
    const FqWork w = {pool.data() + t * P.NP, freel.data() + t * P.NP,
                      heads.data() + t, nullptr, kThreads};
    fq_resident_read(fm, P, ck, order[x], w, out);
  }
  return 0;
}

extern "C" int fq_scan_host(const int32_t* tab, const int32_t* fm_hp,
                            const int32_t* sp, const uint8_t* seqs,
                            const int32_t* lens, const int32_t* md,
                            const int32_t* use_seed, const int32_t* n_n,
                            int N, int32_t* widths, const int32_t* seed_w,
                            void* lanes, int B, void* pool, void* freel,
                            void* heads, int32_t* alns, int k_inner) {
  const FmView fm = fm_view(tab, fm_hp);
  const SearchParams P = search_params(sp);
  const FqChunk ck = {seqs, lens, md, use_seed, n_n, N, widths, seed_w};
  for (int b = 0; b < B; ++b)
    fq_scan_lane(b, fm, P, ck, (FqLane*)lanes, (FqSlot*)pool,
                 (uint16_t*)freel, (int16_t*)heads, alns, k_inner);
  return 0;
}

// The SW kernel's wavefront, one job at a time: strips, steps tau, the 32
// lanes and their __shfl_up_sync exchange, the column buffer and the
// final __shfl_xor_sync reduction, in the kernel's order of evaluation.
extern "C" int fq_sw_host(const uint8_t* refs, const uint8_t* qs,
                          const int32_t* rlens, const int32_t* qlens, int B,
                          int RL, int QL, int32_t* out) {
  const int W = FQ_SW_STRIP;
  std::vector<int32_t> col(2 * (size_t)RL + 1);
  for (int b = 0; b < B; ++b) {
    const uint8_t* ref = refs + (int64_t)b * RL;
    const uint8_t* q = qs + (int64_t)b * QL;
    const int rl = rlens[b], ql = qlens[b];
    SwLane L[FQ_SW_STRIP];
    for (int t = 0; t < W; ++t) sw_lane_job(L[t]);
    for (int s = 0; W * s < ql; ++s) {
      for (int t = 0; t < W; ++t) {
        const int i = W * s + t;
        sw_lane_row(L[t], i < ql ? q[i] : 4);
      }
      const int steps = sw_strip_steps(rl, ql, s);
      for (int tau = 0; tau < steps; ++tau) {
        int up_h[FQ_SW_STRIP], up_e[FQ_SW_STRIP];
        for (int t = 0; t < W; ++t) {  // lane 0 gets its own values
          up_h[t] = L[t > 0 ? t - 1 : 0].h;
          up_e[t] = L[t > 0 ? t - 1 : 0].e;
        }
        for (int t = 0; t < W; ++t)
          sw_lane_step(L[t], t, s, tau, rl, ql, ref, up_h[t], up_e[t],
                       col.data());
      }
    }
    int best[FQ_SW_STRIP], bi[FQ_SW_STRIP], bj[FQ_SW_STRIP];
    for (int t = 0; t < W; ++t) {
      best[t] = L[t].best;
      bi[t] = L[t].bi;
      bj[t] = L[t].bj;
    }
    for (int o = W / 2; o > 0; o >>= 1) {
      int nb[FQ_SW_STRIP], ni[FQ_SW_STRIP], nj[FQ_SW_STRIP];
      for (int t = 0; t < W; ++t) {
        const int u = t ^ o;
        const bool take = sw_before(best[u], bi[u], bj[u], best[t], bi[t],
                                    bj[t]);
        nb[t] = take ? best[u] : best[t];
        ni[t] = take ? bi[u] : bi[t];
        nj[t] = take ? bj[u] : bj[t];
      }
      std::copy(nb, nb + W, best);
      std::copy(ni, ni + W, bi);
      std::copy(nj, nj + W, bj);
    }
    out[4 * b] = best[0];
    out[4 * b + 1] = bi[0];
    out[4 * b + 2] = bj[0];
    out[4 * b + 3] = 0;
  }
  return 0;
}
