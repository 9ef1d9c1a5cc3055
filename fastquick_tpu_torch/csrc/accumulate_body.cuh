// The per-read and per-base body of the accumulation kernels
// (accumulate.cu): a read's fields, loaded once for all its bases; for one
// base j of it, where it falls in the pac text, whether it lies on a dense
// site, its base, quality and reference base, its cycle, its quality tier
// and bins, whether it is a mismatch, and the packed pileup entry of a
// base on a marker.  nvcc builds it into the kernels, g++ into the host
// library (host_kernels.cpp) for the CPU tests.
//
// Two callers, one body (FqAccIn.mode):
// - FQ_ACC_READ (ops/qc_full.qc_step_full): int32 planes in read
//   orientation as bwa stores them: seqs reversed codes, rseqs the
//   reverse complement (reference orientation on strand 1), quals in read
//   order.  With k = min(len - 1 - j, L - 1), the index in the stored
//   reversal (ragged_unreverse's, never materialised): strand 1 takes
//   rseqs[j] and quals[k], strand 0 seqs[k] and quals[j].  Quality
//   clamped to 0..93, cycle clamp(len - 1 - j, 0, L) on strand 1, else j.
//   Only eligible rows count.
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

// One read of a batch, loaded once for all its bases; 32-bit from here
// on (ops/accumulate.acc_call holds B L and n_text + L below 2^31).
struct FqAccRow {
  int pos;           // its pac position, clamped to [-L, n_text + 1]
  int len;           // its length, at most 2 L + 1,024
  int row;           // b * L: the flat index of its base 0
  int n;             // its bases in the grid: min(len, L) (> 0)
  int rev;           // strand 1
  const void* code;  // its codes' row (FQ_ACC_READ: its strand's plane)
  const void* qual;  // its qualities' row
};

// Read b's fields; false when it has no base to count (not eligible, or
// no length).  The clamps of pos and len change no base's pac position,
// slot, cycle or bin: a base's pac is clamped to [0, n_text], its
// len - 1 - j (j < L) to at most max(L, 1,023) wherever it is used.
FQ_HD bool fq_acc_row(const FqAccIn& a, int b, FqAccRow& r) {
  if (a.eligible && !a.eligible[b]) return false;
  const int64_t len = a.lens[b], pos = a.pos[b];
  if (len <= 0) return false;
  r.len = len < 2 * a.L + 1024 ? (int)len : 2 * a.L + 1024;
  r.n = r.len < a.L ? r.len : a.L;
  r.pos = pos < -a.L ? -a.L : (pos > a.n_text ? (int)a.n_text + 1 : (int)pos);
  r.row = b * a.L;
  r.rev = a.strand[b] == 1;
  if (a.mode == FQ_ACC_READ) {
    r.code = (const int32_t*)(r.rev ? a.rseqs : a.seqs) + r.row;
    r.qual = (const int32_t*)a.quals + r.row;
  } else {
    r.code = (const uint8_t*)a.seqs + r.row;
    r.qual = (const uint8_t*)a.quals + r.row;
  }
  return true;
}

// One base of a read.
struct FqAccBase {
  int pac;    // clamp(pos + j, 0, n_text)
  int site;   // its dense-site index (< 0: not in a region)
  int code;   // the read's base in reference orientation
  int bq;     // its clamped quality
  int fb;     // the text's base at pac
  int cycle;  // its cycle (before the histogram's and the pack's clamps)
};

FQ_HD int64_t fq_acc_clamp64(int64_t x, int64_t lo, int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

FQ_HD int fq_acc_pac(const FqAccIn& a, const FqAccRow& r, int j) {
  return fq_clamp(r.pos + j, 0, (int)a.n_text);
}

// Base j < r.n: its pac position and site; true when in a region.
FQ_HD bool fq_acc_locate(const FqAccIn& a, const FqAccRow& r, int j,
                         FqAccBase& o) {
  o.pac = fq_acc_pac(a, r, j);
  o.site = a.site_idx[o.pac];
  return o.site >= 0;
}

// The base's code, quality, cycle and reference base (after
// fq_acc_locate).
FQ_HD void fq_acc_read(const FqAccIn& a, const FqAccRow& r, int j,
                       FqAccBase& o) {
  if (a.mode == FQ_ACC_READ) {
    // j < len, so len - 1 - j >= 0: ragged_unreverse's slot, its clamp
    const int k = fq_min(r.len - 1 - j, a.L - 1);
    o.code = ((const int32_t*)r.code)[r.rev ? j : k];
    o.bq = fq_clamp(((const int32_t*)r.qual)[r.rev ? k : j], 0, 93);
    o.cycle = r.rev ? fq_clamp(r.len - 1 - j, 0, a.L) : j;
  } else {
    o.code = ((const uint8_t*)r.code)[j];
    o.bq = ((const uint8_t*)r.qual)[j];
    o.cycle = r.rev ? r.len - 1 - j : j;
  }
  o.fb = a.text[o.pac];
}

// A mismatch against the text at a site that is not dbSNP (the flag read
// only where the bases differ).
FQ_HD int fq_acc_mism(const FqAccIn& a, const FqAccBase& o) {
  return o.code < 4 && o.fb < 4 && o.code != o.fb && !a.dbsnp[o.site];
}

FQ_HD int fq_acc_tier(int bq) { return (bq >= 20) + (bq >= 30); }

FQ_HD int fq_acc_cycle_bin(int cycle) { return fq_clamp(cycle, 0, 255); }

// ops/qc_full._pack_entry: present(1) | base(3) | qual(7) | mapq(7) |
// strand(1) | cycle(10)
FQ_HD int32_t fq_acc_pack(const FqAccIn& a, const FqAccRow& r, int b,
                          const FqAccBase& o) {
  const int base = fq_clamp(o.code, 0, 4);
  const int mq = (int)fq_acc_clamp64(a.mapq[b], 0, 127);
  const int cyc = fq_clamp(o.cycle, 0, 1023);
  return 1 | (base << 1) | (o.bq << 4) | (mq << 11) | (r.rev << 18) |
         (cyc << 19);
}

// The packed pileup entry of the base of flat index i = b * L + j (an
// entry: an eligible read's base in a region, at a marker).
FQ_HD int32_t fq_acc_entry(const FqAccIn& a, int i) {
  const int b = i / a.L, j = i - b * a.L;
  FqAccRow r;
  FqAccBase o;
  fq_acc_row(a, b, r);
  fq_acc_locate(a, r, j, o);
  fq_acc_read(a, r, j, o);
  return fq_acc_pack(a, r, b, o);
}

// The marker of the entry of flat index i.
FQ_HD int fq_acc_entry_marker(const FqAccIn& a, int i) {
  const int b = i / a.L, j = i - b * a.L;
  return a.marker_id[fq_acc_clamp64(a.pos[b] + j, 0, a.n_text)];
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

// The entry list's counters after the M per-marker counts: the entries
// appended, then the pileup's overflow count.
#define FQ_ACC_N_ENT(M) (M)
#define FQ_ACC_OVF(M) ((M) + 1)

// The slots a marker of n entries keeps at slot offset base (pileup cap):
// entries of rank r < kept go to slot base + r, the rest overflow.
FQ_HD int fq_acc_kept(int n, int base, int cap) {
  return fq_clamp(cap - base, 0, n);
}
