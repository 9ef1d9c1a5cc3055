// Host (g++) build of the kernels' bodies, for the CPU tests: the same
// width_unit / fq_resident_read / fq_scan_* round pieces / sw_lane_step /
// fq_drand_read code that nvcc compiles into width.cu, search.cu,
// scan.cu, sw.cu and drand48.cu, with the kernels' argument layouts and
// their order of evaluation emulated serially.  Never used on the product
// path.
#include <algorithm>
#include <vector>

#include "drand48_body.cuh"
#include "search_body.cuh"
#include "sw_body.cuh"
#include "width_body.cuh"

// width_unit's accessor on the host: the unit's own rows, no staging.
struct WidthRows {
  const uint8_t* codes;
  int32_t *w, *bid;
  void load(int, int) {}
  int code(int i) const { return codes[i]; }
  void put(int i, int wv, int b) {
    w[i] = wv;
    bid[i] = b;
  }
  void store(int, int) {}
};

extern "C" int fq_width_host(const int32_t* tab, const int32_t* fm_hp,
                             const uint8_t* units, const int32_t* sel, int M,
                             int L, int32_t* w, int32_t* bid) {
  const FmView fm = fm_view(tab, fm_hp);
  for (int m = 0; m < M; ++m) {
    const int64_t off = (int64_t)m * L;
    WidthRows io = {units + off, w + off, bid + off};
    width_unit(fm, sel[m], L, io);
  }
  return 0;
}

// The resident kernel's reads in the order order[0..N), on kThreads
// workspaces taken in turn, their bucket heads interleaved as in the
// kernel's shared memory; each workspace is reused from read to read
// without clearing.  A chain length CH > 1 runs the chain kernel's body.
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
    if (P.CH > 1)
      fq_resident_read<true>(fm, P, ck, order[x], w, out);
    else
      fq_resident_read<false>(fm, P, ck, order[x], w, out);
  }
  return 0;
}

// The scan kernel's whole chunk (scan.cu's fq_scan_launch arguments, less
// the sync scratch): each round advances the lanes in order, then flushes
// the lanes that are done and refills them in lane order with the next
// reads, until no lane is live and no read is left below n_ids.  Each
// lane's bucket heads are interleaved with its block's as in the kernel's
// shared memory.  stats: [rounds, busy steps].
extern "C" int fq_scan_host(const int32_t* tab, const int32_t* fm_hp,
                            const int32_t* sp, const uint8_t* seqs,
                            const int32_t* lens, const int32_t* md,
                            const int32_t* use_seed, const int32_t* n_n,
                            int N, int32_t* widths, const int32_t* seed_w,
                            int32_t* alns, int32_t* n_aln, int32_t* fb,
                            int32_t* steps, int B, int k_inner, int n_ids,
                            int64_t* stats) {
  const int T = FQ_SCAN_THREADS;
  const FmView fm = fm_view(tab, fm_hp);
  const SearchParams P = search_params(sp);
  const FqChunk ck = {seqs, lens, md, use_seed, n_n, N, widths, seed_w};
  const FqOut out = {alns, n_aln, fb, steps, nullptr};
  std::vector<FqSlot> pool((size_t)P.NP * B);
  std::vector<uint16_t> freel((size_t)P.NP * B);
  std::vector<int16_t> heads((size_t)FQ_NBUCK * T * ((B + T - 1) / T));
  std::vector<FqLane> lanes(B);
  std::vector<char> flushed(B);
  for (int b = 0; b < B; ++b) fq_scan_refill(lanes[b], ck, b);
  int next_read = B;
  int64_t rounds = 0, busy = 0;
  auto live = [&] {
    return std::any_of(lanes.begin(), lanes.end(),
                       [](const FqLane& s) { return !s.done; });
  };
  while (live() || next_read < n_ids) {
    for (int b = 0; b < B; ++b) {
      const FqWork w = {pool.data() + (size_t)b * P.NP,
                        freel.data() + (size_t)b * P.NP,
                        heads.data() + (size_t)(b / T) * T * FQ_NBUCK + b % T,
                        nullptr, T};
      fq_scan_advance(lanes[b], fm, P, ck, w, out, k_inner);
    }
    for (int b = 0; b < B; ++b) {
      flushed[b] = fq_scan_flush(lanes[b], out);
      if (flushed[b]) busy += lanes[b].steps;
    }
    int rank = 0;
    for (int b = 0; b < B; ++b)
      if (flushed[b]) fq_scan_refill(lanes[b], ck, next_read + rank++);
    next_read += rank;
    ++rounds;
  }
  stats[0] = rounds;
  stats[1] = busy;
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

// The drand48 kernel's walk (drand48.cu's fq_drand48_launch arguments):
// the batch's reads in order on one stream, each read's first row read
// from its hit rows as the kernel reads it from shared memory.
extern "C" int fq_drand48_host(const int32_t* n_aln, const int32_t* alns,
                               int N, const int32_t* state_in, int32_t* f0,
                               int32_t* row, int32_t* state_out) {
  uint64_t x = fq_drand_load(state_in);
  for (int r = 0; r < N; ++r) {
    const int32_t* rows = alns + (int64_t)r * FQ_DRAND_A_MAX * 3;
    fq_drand_read(x, fq_drand_best(rows, n_aln[r]), rows, rows, f0 + r,
                  row + r);
  }
  fq_drand_store(x, state_out);
  return 0;
}
