// Host (g++) build of the kernels' bodies, for the CPU tests: the same
// width_unit / fq_resident_read / fq_scan_* round pieces / sw_lane_step /
// fq_drand_* / fq_pair_sweep / fq_acc_* code that nvcc compiles into
// width.cu, search.cu, scan.cu, sw.cu, drand48.cu, pairing.cu and
// accumulate.cu, with the kernels'
// argument layouts and their order of evaluation emulated serially.
// Never used on the product path.
#include <algorithm>
#include <climits>
#include <vector>

#include "accumulate_body.cuh"
#include "drand48_body.cuh"
#include "pairing_body.cuh"
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

// The drand48 kernel's tiles (drand48.cu's fq_drand48_launch arguments),
// their phases in order: classify and rank the tile's reads (the tile ends
// where the serial reads' rows would pass FQ_DRAND_ROWS), walk the serial
// reads with a jump across each run of single reads and each row's
// acceptance threshold, draw each read from its own start state, and end
// the tile at its first single read whose first draw is 0, the
// next tile starting after it from state 0.  Outputs are written where
// the kernel writes them, so a read after a broken one is written twice.
extern "C" int fq_drand48_host(const int32_t* n_aln, const int32_t* alns,
                               int N, const int32_t* state_in, int32_t* f0,
                               int32_t* row, int32_t* state_out) {
  const int T = FQ_DRAND_TILE;
  std::vector<int> nb(T), cls(T), seg(T), sgl(T), ser, sser, off;
  std::vector<int32_t> f(T), k(T), w(T), rw, rk, rf;
  std::vector<uint64_t> pre, post, rt;
  uint64_t ta[FQ_DRAND_JUMP_BITS], tc[FQ_DRAND_JUMP_BITS];
  for (int b = 0; b < FQ_DRAND_JUMP_BITS; ++b)
    fq_drand_power(1u << b, ta[b], tc[b]);
  uint64_t x0 = fq_drand_load(state_in);
  int base = 0;
  while (base < N) {
    // 1. classify and rank
    int n_t = 0, need = 0, n_sgl = 0;
    ser.clear();
    sser.clear();
    off.clear();
    rw.clear();
    rk.clear();
    rf.clear();
    rt.clear();
    for (int t = 0; t < T && base + t < N; ++t) {
      const int32_t* rows = alns + (int64_t)(base + t) * FQ_DRAND_A_MAX * 3;
      nb[t] = fq_drand_best(rows, n_aln[base + t]);
      f[t] = rows[0];
      k[t] = rows[1];
      w[t] = rows[2] - rows[1] + 1;
      cls[t] = fq_drand_class(nb[t], w[t]);
      if (cls[t] == FQ_DRAND_SERIAL) {
        if (need + nb[t] > FQ_DRAND_ROWS) break;
        need += nb[t];
      }
      seg[t] = (int)ser.size();
      sgl[t] = n_sgl;
      if (cls[t] == FQ_DRAND_SERIAL) {
        ser.push_back(t);
        sser.push_back(n_sgl);
        off.push_back((int)rw.size());
        int32_t cnt = 0;
        for (int i = 0; i < nb[t]; ++i) {
          rf.push_back(rows[3 * i]);
          rk.push_back(rows[3 * i + 1]);
          rw.push_back(rows[3 * i + 2] - rows[3 * i + 1] + 1);
          rt.push_back(fq_drand_threshold(rw.back(), cnt));
          cnt += rw.back();
        }
      }
      n_sgl += cls[t] == FQ_DRAND_SINGLE;
      n_t = t + 1;
    }
    // 2. the serial walk
    const int n_ser = (int)ser.size();
    pre.resize(n_ser);
    post.resize(n_ser);
    uint64_t x = x0, a, c;
    for (int j = 0; j < n_ser; ++j) {
      fq_drand_power(2u * (sser[j] - (j ? sser[j - 1] : 0)), a, c);
      x = fq_drand_apply(a, c, x);
      pre[j] = x;
      x = fq_drand_chain(x, nb[ser[j]], rt.data() + off[j]);
      post[j] = x;
    }
    const uint64_t xe = fq_drand_jump(
        ta, tc, 2u * (n_sgl - (n_ser ? sser[n_ser - 1] : 0)), x);
    // 3. each read from its own start state
    int brk = T;
    for (int t = 0; t < n_t; ++t) {
      const int r = base + t, j = seg[t];
      if (cls[t] == FQ_DRAND_SERIAL) {
        uint64_t xs = pre[j];
        const int o = off[j];
        fq_drand_walk(xs, nb[t], rt.data() + o, rk.data() + o,
                      rw.data() + o, rf.data() + o, f0[r], row[r]);
      } else if (cls[t] == FQ_DRAND_SINGLE) {
        const uint64_t xs = fq_drand_jump(
            ta, tc, 2u * (sgl[t] - (j ? sser[j - 1] : 0)),
            j ? post[j - 1] : x0);
        if (!fq_drand_single(xs, f[t], k[t], w[t], f0[r], row[r]))
          brk = std::min(brk, t);
      } else if (cls[t] == FQ_DRAND_EMPTY) {
        f0[r] = 0;
        row[r] = 0;
      }
    }
    // 4. the next tile
    if (brk < n_t) {
      f0[base + brk] = 0;
      row[base + brk] = 0;
      x0 = 0;
      base += brk + 1;
    } else {
      x0 = xe;
      base += n_t;
    }
  }
  fq_drand_store(x0, state_out);
  return 0;
}

// The pairing kernels (pairing.cu's fq_pairing_launch arguments), their
// steps in order.  2 K <= 64: the warp kernel, a tile of 32 pairs at a
// time: each group's keys, its network over the 64 slots stage by stage
// (every slot takes fq_pair_cx of itself and of its partner s ^ j as the
// stage before left them: a lane's shuffle partner or its other key) and
// the sorted keys into the scratch, then each pair's sweep from there.
// Else the block kernel: each pair's network over its own keys alike, its
// sweep.  cnt is zeroed by the caller.
extern "C" int fq_pairing_host(FQ_PAIR_IN_ARGS, int32_t* out,
                               uint8_t* proper, int32_t* cnt,
                               int64_t* scratch) {
  const FqPairIn in = fq_pair_in(FQ_PAIR_IN_NAMES);
  const FqPairOut o = {out, proper, cnt};
  std::vector<uint64_t> key, prev;
  auto network = [&](int m, int seg) {  // m slots in segments of seg
    for (int k = 2; k <= seg; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        prev = key;
        for (int s = 0; s < m; ++s)
          key[s] = fq_pair_cx(prev[s], prev[s ^ j], s & (seg - 1), j, k);
      }
    }
  };
  if (2 * K > FQ_PAIR_WARP_NK) {
    for (int p = 0; p < P; ++p) {
      int c0, c1;
      fq_pair_counts(in, p, c0, c1);
      const int n = c0 + c1, m = fq_pair_span(n);
      key.resize(m);
      for (int i = 0; i < m; ++i) key[i] = fq_pair_key(in, p, i, c0, n);
      network(m, m);
      *cnt += fq_pair_sweep(in, p, key.data(), 1, n, o);
    }
    return 0;
  }
  const int W = 32, NK = FQ_PAIR_WARP_NK;
  uint64_t* sk = (uint64_t*)scratch;
  int c0[W], nn[W], span[W];
  int64_t at[NK];
  key.resize(NK);
  for (int base = 0; base < P; base += W) {
    for (int q = 0; q < W; ++q) {
      int c1 = 0;
      c0[q] = 0;
      if (base + q < P) fq_pair_counts(in, base + q, c0[q], c1);
      nn[q] = c0[q] + c1;
      span[q] = fq_pair_span(nn[q]);
    }
    for (int q = 0; q < W;) {
      int g = 1, M = span[q];
      while (q + g < W && fq_pair_group_takes(g, M, span[q + g])) ++g;
      for (int s = 0; s < NK; ++s) {
        const int pq = q + s / M, i = s % M;
        const bool v = s < g * M && i < nn[pq & 31];
        key[s] = v ? fq_pair_key(in, base + pq, i, c0[pq], nn[pq])
                   : FQ_PAIR_PAD;
        at[s] = v ? (int64_t)i * P + base + pq : -1;
      }
      network(NK, M);
      for (int s = 0; s < NK; ++s)
        if (at[s] >= 0) sk[at[s]] = key[s];
      q += g;
    }
    for (int q = 0; q < W && base + q < P; ++q)
      *cnt += fq_pair_sweep(in, base + q, sk + base + q, P, nn[q], o);
  }
  return 0;
}

// The walk kernel's grid (accumulate.cu's fq_accum_walk_launch arguments;
// nblocks its grid of FQ_WALK_WARPS warps a block), in an order the
// device might take: the blocks, and each block's warps, from last to
// first (the entries' list comes out in no read order by chance); each
// warp's reads, and each read's groups of 4 rounds stage by stage: the
// rounds' sums lane by lane (the site counts, the cycle bins, then the
// warp's quality bins a group of equal values at a time, as
// __match_any_sync groups them), then the rounds' entries appended in lane
// order; then the block's nonzero bins and region count into the output.  The adds wrap
// mod 2^32 as the device's atomics do.  out zeroed here when zero_out,
// counts when given (entries listed).
extern "C" int fq_accum_walk_host(FQ_ACC_IN_ARGS, int nblocks, int32_t* out,
                                  int zero_out, int32_t* ent,
                                  int32_t* counts, int M) {
  const FqAccIn a = fq_acc_in(FQ_ACC_IN_NAMES);
  const int W = 16, G = 4, BUF = 1024;  // FQ_WALK_WARPS, _GROUP, _ENT_BUF
  const bool D = out != nullptr, E = counts != nullptr;
  auto add = [](int32_t& x, int v) { x = (int32_t)((uint32_t)x + v); };
  if (D && zero_out) std::fill(out, out + fq_acc_out_size(S), 0);
  if (E) std::fill(counts, counts + M + 2, 0);
  if (B <= 0 || L <= 0 || (!D && !E)) return 0;
  int32_t* hist = D ? out + fq_acc_hist_at(S, 0) : nullptr;
  std::vector<int32_t> h(4 * 256);
  std::vector<int32_t> sent;  // the block's entries (shared memory)
  for (int blk = nblocks - 1; blk >= 0; --blk) {
    std::fill(h.begin(), h.end(), 0);
    int n_reg = 0;
    sent.clear();
    bool full = false;  // an append did not fit: it and later ones go on
    for (int w = W - 1; w >= 0; --w) {
      for (int b = blk * W + w; b < B; b += nblocks * W) {
        FqAccRow r;
        if (!fq_acc_row(a, b, r)) continue;
        for (int j0 = 0; j0 < r.n; j0 += 32 * G) {
          FqAccBase o[4][32];
          int mk[4][32];
          bool in[4][32];
          for (int g = 0; g < G; ++g)
            for (int l = 0; l < 32; ++l) {
              const int j = j0 + 32 * g + l;
              in[g][l] = false;
              mk[g][l] = -1;
              if (j >= r.n) continue;
              if (D) {
                in[g][l] = fq_acc_locate(a, r, j, o[g][l]);
              } else {
                o[g][l].pac = fq_acc_pac(a, r, j);
                mk[g][l] = a.marker_id[o[g][l].pac];
                in[g][l] = mk[g][l] >= 0 && a.site_idx[o[g][l].pac] >= 0;
              }
            }
          for (int g = 0; g < G; ++g)
            for (int l = 0; l < 32; ++l)
              if (in[g][l] && D) {
                fq_acc_read(a, r, j0 + 32 * g + l, o[g][l]);
                if (E) mk[g][l] = a.marker_id[o[g][l].pac];
              }
          for (int g = 0; g < G && j0 + 32 * g < r.n && D; ++g) {
            {
              int qkey[32];
              for (int l = 0; l < 32; ++l) {
                qkey[l] = -1;
                if (!in[g][l]) continue;
                const FqAccBase& x = o[g][l];
                const int mism = fq_acc_mism(a, x);
                const int tier = fq_acc_tier(x.bq);
                add(out[x.site], 1);
                if (tier > 0) add(out[S + x.site], 1);
                if (tier > 1) add(out[2 * (int64_t)S + x.site], 1);
                const int cb = fq_acc_cycle_bin(x.cycle);
                ++h[2 * 256 + cb];
                if (mism) ++h[3 * 256 + cb];
                qkey[l] = x.bq << 1 | mism;
                ++n_reg;
              }
              for (int l = 0; l < 32; ++l) {
                if (qkey[l] < 0) continue;
                int c = 0, first = l;
                for (int k = 0; k < 32; ++k)
                  if (qkey[k] == qkey[l]) {
                    ++c;
                    first = std::min(first, k);
                  }
                if (first != l) continue;
                h[qkey[l] >> 1] += c;
                if (qkey[l] & 1) h[256 + (qkey[l] >> 1)] += c;
              }
            }
          }
          for (int g = 0; g < G && E; ++g) {
            int c = 0;
            for (int l = 0; l < 32; ++l) c += in[g][l] && mk[g][l] >= 0;
            const bool fits = !full && (int)sent.size() + c <= BUF;
            full = !fits && c;
            for (int l = 0; l < 32; ++l)
              if (in[g][l] && mk[g][l] >= 0) {
                const int32_t idx = r.row + j0 + 32 * g + l;
                if (fits)
                  sent.push_back(idx);
                else
                  ent[counts[FQ_ACC_N_ENT(M)]++] = idx;
                ++counts[mk[g][l]];
              }
          }
        }
      }
    }
    for (int32_t idx : sent) ent[counts[FQ_ACC_N_ENT(M)]++] = idx;
    if (!D) continue;
    for (int k = 0; k < 4 * 256; ++k)
      if (h[k]) add(hist[k], h[k]);
    if (n_reg) add(hist[4 * 256], n_reg);
  }
  return 0;
}

// The order kernels' three steps in order (accumulate.cu's
// fq_accum_order_launch arguments): the exclusive scan of the marker
// counts, the listed entries into their buckets in list order, then each
// marker's warp: up to 32 entries ranked by comparing each index with the
// others, more by taking the next smallest index once a kept slot.
// pileup zeroed here.
extern "C" int fq_accum_order_host(FQ_ACC_IN_ARGS,
                                   const int32_t* marker_base, int M,
                                   int cap, const int32_t* ent,
                                   int32_t* counts, int32_t* pileup,
                                   int32_t* off, int32_t* bucket) {
  const FqAccIn a = fq_acc_in(FQ_ACC_IN_NAMES);
  std::fill(pileup, pileup + (int64_t)M * cap, 0);
  if (M <= 0) return 0;
  const int32_t* cnt = counts;
  int32_t& ovf = counts[FQ_ACC_OVF(M)];
  off[0] = 0;
  for (int m = 0; m < M; ++m) off[m + 1] = off[m] + cnt[m];
  for (int t = 0; t < counts[FQ_ACC_N_ENT(M)]; ++t)
    bucket[off[fq_acc_entry_marker(a, ent[t])]++] = ent[t];
  for (int m = 0; m < M; ++m) {
    const int n = cnt[m], base = marker_base ? marker_base[m] : 0;
    const int kept = fq_acc_kept(n, base, cap);
    const int32_t* bk = bucket + (off[m] - n);
    int32_t* row = pileup + (int64_t)m * cap + base;
    ovf += n - kept;
    if (!kept) continue;
    if (n <= 32) {
      for (int l = 0; l < n; ++l) {
        int rank = 0;
        for (int k = 0; k < n; ++k) rank += bk[k] < bk[l];
        if (rank < kept && base + rank >= 0)
          row[rank] = fq_acc_entry(a, bk[l]);
      }
      continue;
    }
    int last = -1;
    for (int r = 0; r < kept; ++r) {
      int lo = INT_MAX;
      for (int t = 0; t < n; ++t)
        if (bk[t] > last && bk[t] < lo) lo = bk[t];
      last = lo;
      if (base + r >= 0) row[r] = fq_acc_entry(a, last);
    }
  }
  return 0;
}
