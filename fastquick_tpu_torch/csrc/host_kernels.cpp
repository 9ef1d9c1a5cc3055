// Host (g++) build of the kernels' per-item bodies, for the CPU tests: the
// same width_unit / search_read / fq_scan_lane / sw_forward_job code that
// nvcc compiles into width.cu, search.cu, scan.cu and sw.cu, looped over
// the items serially with the kernels' argument layouts.  Never used on
// the product path.
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

extern "C" int fq_search_host(const int32_t* tab, const int32_t* fm_hp,
                              const int32_t* sp, const uint8_t* seqs,
                              const int32_t* lens, const int32_t* md,
                              const int32_t* use_seed, const int32_t* n_n,
                              int N, int32_t* widths, const int32_t* seed_w,
                              int32_t* alns, int32_t* n_aln, int32_t* fb,
                              int32_t* steps) {
  const FmView fm = fm_view(tab, fm_hp);
  const SearchParams P = search_params(sp);
  std::vector<FqSlot> pool(P.NP);
  std::vector<uint16_t> freel(P.NP);
  std::vector<int16_t> heads(FQ_NBUCK);
  const int64_t LW = 2 * (P.L + 1), SW = 2 * (P.SL + 1);
  for (int r = 0; r < N; ++r) {
    const SearchOut o = search_read(
        fm, P, seqs + (int64_t)r * P.L, lens[r], md[r], use_seed[r], n_n[r],
        widths + r * LW, widths + (N + r) * LW, seed_w + r * SW,
        seed_w + (N + r) * SW, pool.data(), freel.data(), heads.data(),
        alns + (int64_t)r * FQ_A_MAX * 3);
    n_aln[r] = o.n_aln;
    fb[r] = o.fb;
    steps[r] = o.steps;
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
  for (int b = 0; b < B; ++b)
    fq_scan_lane(b, fm, P, seqs, lens, md, use_seed, n_n, N, widths, seed_w,
                 (FqLane*)lanes, (FqSlot*)pool, (uint16_t*)freel,
                 (int16_t*)heads, alns, k_inner);
  return 0;
}

extern "C" int fq_sw_host(const uint8_t* refs_t, const uint8_t* qs_t,
                          const int32_t* rlens, const int32_t* qlens, int B,
                          int32_t* h_t, int32_t* e_t, int32_t* out) {
  for (int b = 0; b < B; ++b)
    sw_forward_job(refs_t + b, qs_t + b, B, rlens[b], qlens[b], h_t + b,
                   e_t + b, out + 4 * b);
  return 0;
}
