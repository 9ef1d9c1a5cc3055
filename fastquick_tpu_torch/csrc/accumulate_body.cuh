// The per-base body of the accumulation kernels (accumulate.cu): for one
// base (b, j) of a batch, where it falls in the pac text, whether it lies
// on a dense site, its base and quality in reference orientation, its
// cycle, its quality tier and bins, whether it is a mismatch, and the
// packed pileup entry of a base on a marker.  nvcc builds it into the
// kernels, g++ into the host library (host_kernels.cpp) for the CPU tests.
//
// Two callers, one body (FqAccIn.mode):
// - FQ_ACC_READ (ops/qc_full.qc_step_full): int32 planes in read
//   orientation as bwa stores them: seqs reversed codes, rseqs reversed
//   complement codes, quals in read order.  A base is read at its own
//   index in the stored reversal (ragged_unreverse's, never materialised):
//   k = min(len - 1 - j, L - 1); strand 1 takes rseqs[k] and quals[j],
//   strand 0 seqs[k] and quals[k].  Quality clamped to 0..93, cycle
//   clamp(len - 1 - j, 0, L) on strand 1, else j.  Only eligible rows
//   count.
// - FQ_ACC_REF (align/device_qc.DeviceDenseStats): uint8 codes and quals
//   already in reference orientation (quals after - 33 with uint8 wrap),
//   so quality is 0..255 as it comes; cycle len - 1 - j on strand 1, else
//   j; every row counts.
#pragma once

#include "fq_common.cuh"

#define FQ_ACC_READ 0
#define FQ_ACC_REF 1

struct FqAccIn {
  const void *seqs, *rseqs, *quals;  // (B, L) planes (rseqs: READ only)
  const int64_t *pos, *strand, *lens;  // (B,)
  const uint8_t* eligible;  // (B,) bool, or null: every row
  const int64_t* mapq;      // (B,) (the pileup entry's) or null
  const int32_t *site_idx, *marker_id, *text;  // (n_text + 1,)
  const uint8_t* dbsnp;  // (S,) bool
  int64_t n_text;
  int B, L, S, mode;
};

// The C interface of both kernels' inputs (launch and host functions).
#define FQ_ACC_IN_ARGS                                                    \
  const void *seqs, const void *rseqs, const void *quals,                 \
      const int64_t *pos, const int64_t *strand, const int64_t *lens,     \
      const uint8_t *eligible, const int64_t *mapq,                       \
      const int32_t *site_idx, const int32_t *marker_id,                  \
      const int32_t *text, const uint8_t *dbsnp, long long n_text, int B, \
      int L, int S, int mode
#define FQ_ACC_IN_NAMES                                                \
  seqs, rseqs, quals, pos, strand, lens, eligible, mapq, site_idx,    \
      marker_id, text, dbsnp, n_text, B, L, S, mode

static inline FqAccIn fq_acc_in(FQ_ACC_IN_ARGS) {
  FqAccIn a;
  a.seqs = seqs;
  a.rseqs = rseqs;
  a.quals = quals;
  a.pos = pos;
  a.strand = strand;
  a.lens = lens;
  a.eligible = eligible;
  a.mapq = mapq;
  a.site_idx = site_idx;
  a.marker_id = marker_id;
  a.text = text;
  a.dbsnp = dbsnp;
  a.n_text = n_text;
  a.B = B;
  a.L = L;
  a.S = S;
  a.mode = mode;
  return a;
}

// One base on a dense site.
struct FqAccBase {
  int64_t pac;    // clamp(pos + j, 0, n_text)
  int site;       // its dense-site index (>= 0)
  int code;       // the read's base in reference orientation
  int bq;         // its clamped quality
  int rev;        // strand 1
  int64_t cycle;  // its cycle (before the histogram's and the pack's clamps)
};

FQ_HD int64_t fq_acc_clamp64(int64_t x, int64_t lo, int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Base (b, j) in a region: covered (eligible row, j < len) and its pac
// position on a dense site.  Fills pac and site; true when in a region.
FQ_HD bool fq_acc_locate(const FqAccIn& a, int b, int j, FqAccBase& o) {
  if ((a.eligible && !a.eligible[b]) || j >= a.lens[b]) return false;
  o.pac = fq_acc_clamp64(a.pos[b] + j, 0, a.n_text);
  o.site = a.site_idx[o.pac];
  return o.site >= 0;
}

// The base's code, quality, strand and cycle (after fq_acc_locate).
FQ_HD void fq_acc_read(const FqAccIn& a, int b, int j, FqAccBase& o) {
  const int64_t len = a.lens[b];
  const int64_t row = (int64_t)b * a.L;
  o.rev = a.strand[b] == 1;
  if (a.mode == FQ_ACC_READ) {
    // j < len, so len - 1 - j >= 0: ragged_unreverse's slot, its clamp
    const int64_t k = len - 1 - j < a.L - 1 ? len - 1 - j : a.L - 1;
    const int32_t* s = (const int32_t*)(o.rev ? a.rseqs : a.seqs);
    const int32_t* q = (const int32_t*)a.quals;
    o.code = s[row + k];
    o.bq = fq_clamp(q[row + (o.rev ? j : k)], 0, 93);
    o.cycle = o.rev ? fq_acc_clamp64(len - 1 - j, 0, a.L) : j;
  } else {
    o.code = ((const uint8_t*)a.seqs)[row + j];
    o.bq = ((const uint8_t*)a.quals)[row + j];
    o.cycle = o.rev ? len - 1 - j : j;
  }
}

// A mismatch against the text at a site that is not dbSNP.
FQ_HD int fq_acc_mism(const FqAccIn& a, const FqAccBase& o) {
  const int fb = a.text[o.pac];
  return o.code < 4 && fb < 4 && o.code != fb && !a.dbsnp[o.site];
}

FQ_HD int fq_acc_tier(int bq) { return (bq >= 20) + (bq >= 30); }

FQ_HD int fq_acc_cycle_bin(int64_t cycle) {
  return (int)fq_acc_clamp64(cycle, 0, 255);
}

// ops/qc_full._pack_entry: present(1) | base(3) | qual(7) | mapq(7) |
// strand(1) | cycle(10)
FQ_HD int32_t fq_acc_pack(const FqAccIn& a, int b, const FqAccBase& o) {
  const int base = fq_clamp(o.code, 0, 4);
  const int mq = (int)fq_acc_clamp64(a.mapq[b], 0, 127);
  const int cyc = (int)fq_acc_clamp64(o.cycle, 0, 1023);
  return 1 | (base << 1) | (o.bq << 4) | (mq << 11) | (o.rev << 18) |
         (cyc << 19);
}

// The marker a base of flat index i = b * L + j enters, or -1: covered,
// at a marker's pac position and in a region.  The marker word first: few
// bases have one, so most read one table word, not two.
FQ_HD int fq_acc_marker(const FqAccIn& a, int i) {
  const int b = i / a.L, j = i - b * a.L;
  if ((a.eligible && !a.eligible[b]) || j >= a.lens[b]) return -1;
  const int64_t pac = fq_acc_clamp64(a.pos[b] + j, 0, a.n_text);
  const int mk = a.marker_id[pac];
  return mk >= 0 && a.site_idx[pac] >= 0 ? mk : -1;
}

// The packed pileup entry of the base of flat index i (an entry).
FQ_HD int32_t fq_acc_entry(const FqAccIn& a, int i) {
  const int b = i / a.L, j = i - b * a.L;
  FqAccBase o;
  fq_acc_locate(a, b, j, o);
  fq_acc_read(a, b, j, o);
  return fq_acc_pack(a, b, o);
}

// The layout of the dense output (ops/accumulate.DENSE_FIELDS): depth,
// q20, q30 (S each), emp_rep, mis_emp_rep, emp_cycle, mis_emp_cycle (256
// each), n_base_mapped (1).
FQ_HD int64_t fq_acc_out_size(int S) { return 3 * (int64_t)S + 4 * 256 + 1; }

// Histogram h (0 emp_rep, 1 mis_emp_rep, 2 emp_cycle, 3 mis_emp_cycle)
// in the dense output.
FQ_HD int64_t fq_acc_hist_at(int S, int h) {
  return 3 * (int64_t)S + 256 * h;
}

// depth, q20 and q30 of site s from the tiers' counts dense3 (3 (S + 1)):
// sums mod 2^32, as the plain version's int64 sums cast to int32.
FQ_HD void fq_acc_finish_site(const int32_t* dense3, int S, int s,
                              int32_t* out) {
  const uint32_t t0 = (uint32_t)dense3[s];
  const uint32_t t1 = (uint32_t)dense3[S + 1 + s];
  const uint32_t t2 = (uint32_t)dense3[2 * (S + 1) + s];
  out[s] = (int32_t)(t0 + t1 + t2);
  out[S + s] = (int32_t)(t1 + t2);
  out[2 * (int64_t)S + s] = (int32_t)t2;
}

// The slots a marker of n entries keeps at slot offset base (pileup cap):
// entries of rank r < kept go to slot base + r, the rest overflow.
FQ_HD int fq_acc_kept(int n, int base, int cap) {
  return fq_clamp(cap - base, 0, n);
}
