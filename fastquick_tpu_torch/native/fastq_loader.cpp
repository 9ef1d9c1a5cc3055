// Native FASTQ batch loader + quality trimming + k-mer filter.
//
// TPU-native equivalent of the reference's C IO stack (libbwa/bwaseqio.c
// kseq readers, bwa_trim_read at bwaseqio.c:75-88, and the hot
// IsReadFiltered path src/BwtIndexer.cpp:498-543): streams gzip FASTQ,
// nt4-encodes, trims, runs the six-projection rolling-hash filter against
// caller-provided bitmaps, and packs fixed-stride batches for the device.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>
#include <zlib.h>

namespace {

constexpr int BWA_MIN_RDLEN = 35;
constexpr int KMER_SIZE = 32;

struct Reader {
  gzFile fp = nullptr;
  std::string buf;
  size_t pos = 0;
  bool eof = false;

  bool fill() {
    if (eof) return false;
    char tmp[1 << 16];
    int n = gzread(fp, tmp, sizeof(tmp));
    if (n <= 0) {
      eof = true;
      return false;
    }
    buf.append(tmp, n);
    return true;
  }

  // getline into out; returns false at EOF
  bool getline(std::string &out) {
    out.clear();
    for (;;) {
      size_t nl = buf.find('\n', pos);
      if (nl != std::string::npos) {
        out.assign(buf, pos, nl - pos);
        pos = nl + 1;
        if (pos > (1 << 20)) {
          buf.erase(0, pos);
          pos = 0;
        }
        if (!out.empty() && out.back() == '\r') out.pop_back();
        return true;
      }
      if (!fill()) {
        if (pos < buf.size()) {
          out.assign(buf, pos, buf.size() - pos);
          pos = buf.size();
          return !out.empty();
        }
        return false;
      }
    }
  }
};

unsigned char nt4_table[256];

struct Nt4Init {
  Nt4Init() {
    memset(nt4_table, 4, sizeof(nt4_table));
    const char *b = "ACGT";
    for (int i = 0; i < 4; ++i) {
      nt4_table[(int)b[i]] = i;
      nt4_table[(int)tolower(b[i])] = i;
    }
  }
} nt4_init;

inline uint32_t shrink(uint64_t k, int t) {
  switch (t) {
    case 0: return (uint32_t)(k >> 32);
    case 1: return (uint32_t)k;
    case 2: return (uint32_t)(((k & 0xFFFF000000000000ULL) >> 32) | (k & 0xFFFFULL));
    case 3: return (uint32_t)((k & 0x0000FFFFFFFF0000ULL) >> 16);
    case 4: return (uint32_t)(((k & 0xFFFF000000000000ULL) >> 32) | ((k & 0xFFFF0000ULL) >> 16));
    default: return (uint32_t)(((k & 0xFFFF00000000ULL) >> 16) | (k & 0xFFFFULL));
  }
}

}  // namespace

extern "C" {

void *fq_open(const char *path) {
  gzFile fp = gzopen(path, "rb");
  if (!fp) return nullptr;
  gzbuffer(fp, 1 << 20);
  Reader *r = new Reader();
  r->fp = fp;
  return r;
}

void fq_close(void *h) {
  Reader *r = (Reader *)h;
  if (r) {
    gzclose(r->fp);
    delete r;
  }
}

// bwa_trim_read (bwaseqio.c:75-88); quals are phred+33 bytes.
int fq_trim_len(int trim_qual, const uint8_t *qual, int len) {
  if (trim_qual < 1 || len == 0) return len;
  int s = 0, max = 0, max_l = len - 1;
  for (int l = len - 1; l >= BWA_MIN_RDLEN - 1; --l) {
    s += trim_qual - (qual[l] - 33);
    if (s < 0) break;
    if (s > max) {
      max = s;
      max_l = l;
    }
  }
  return max_l + 1;
}

// Six-projection vote count over the first 3 in-bounds chunks
// (IsReadInHashByCountMoreChunck, clamped like the Python path).
int fq_kmer_votes(const uint8_t *const *bitmaps, const uint8_t *codes,
                  int len, int thresh) {
  int n_chunk = len / KMER_SIZE;
  if (n_chunk > 3) n_chunk = 3;
  int count = 0;
  for (int c = 0; c < n_chunk; ++c) {
    uint64_t k = 0;
    for (int j = 0; j < KMER_SIZE; ++j)
      k = (k << 2) | codes[c * KMER_SIZE + j];
    for (int t = 0; t < 6; ++t) {
      uint32_t s = shrink(k, t);
      if (bitmaps[t][s >> 3] & (1u << (s & 7))) ++count;
    }
    if (count >= thresh) return count;
  }
  return count;
}

// Read up to n_max records.  Outputs (fixed stride max_len):
//   seqs:  uint8 nt4 codes (4 beyond each read's full length)
//   quals: uint8 phred+33 (0 padding)
//   lens / full_lens: int32 (len = post-trim)
//   filtered: uint8 (1 = dropped by the k-mer filter)
//   names: char[n_max][name_stride] NUL-terminated, /1 /2 suffix stripped
// bitmaps: array of 6 pointers to 512MiB tables, or NULL to skip filter.
// Returns the number of records read (0 at EOF, -1 on malformed input).
int fq_read_batch(void *h, int n_max, int max_len, int trim_qual,
                  const uint8_t *const *bitmaps, int thresh,
                  uint8_t *seqs, uint8_t *quals, int32_t *lens,
                  int32_t *full_lens, uint8_t *filtered, char *names,
                  int name_stride) {
  Reader *r = (Reader *)h;
  std::string l1, l2, l3, l4;
  int n = 0;
  while (n < n_max) {
    if (!r->getline(l1)) break;
    if (l1.empty()) continue;
    if (!r->getline(l2)) return -1;
    if (!r->getline(l3)) return -1;
    if (l3.size() && l3[0] == '+') {
      if (!r->getline(l4)) return -1;
    } else {
      l4.clear();
    }
    int L = (int)l2.size();
    if (L > max_len) L = max_len;
    uint8_t *sp = seqs + (size_t)n * max_len;
    uint8_t *qp = quals + (size_t)n * max_len;
    memset(sp, 4, max_len);
    memset(qp, 0, max_len);
    for (int i = 0; i < L; ++i) sp[i] = nt4_table[(unsigned char)l2[i]];
    int qlen = (int)l4.size() < L ? (int)l4.size() : L;
    for (int i = 0; i < qlen; ++i) qp[i] = (uint8_t)l4[i];
    full_lens[n] = L;
    int tl = l4.empty() ? L : fq_trim_len(trim_qual, qp, L);
    lens[n] = tl;
    filtered[n] = 0;
    if (bitmaps && thresh > 0)
      filtered[n] = fq_kmer_votes(bitmaps, sp, tl, thresh) >= thresh ? 0 : 1;
    // name: skip '@', cut at first whitespace, strip /1 /2
    size_t start = l1[0] == '@' ? 1 : 0;
    size_t end = l1.find_first_of(" \t", start);
    if (end == std::string::npos) end = l1.size();
    size_t nl = end - start;
    if (nl > 2 && l1[end - 2] == '/' &&
        (l1[end - 1] == '1' || l1[end - 1] == '2'))
      nl -= 2;
    if ((int)nl >= name_stride) nl = name_stride - 1;
    memcpy(names + (size_t)n * name_stride, l1.data() + start, nl);
    names[(size_t)n * name_stride + nl] = 0;
    ++n;
  }
  return n;
}

}  // extern "C"
