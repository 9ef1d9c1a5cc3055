"""Read records and FASTQ batch loading.

Equivalent of bwa_seq_t plus bwa_read_seq_with_hash[_dev]
(reference src/BwtMapper.cpp:344-620): gzip FASTQ streaming, optional
Bernoulli downsampling with a per-batch-seeded RNG, nst_nt4 encoding,
quality trimming (bwa_trim_read, libbwa/bwaseqio.c:75-88), k-mer
filtering, and the seq/rseq reverse / reverse-complement convention
(seq_reverse calls at BwtMapper.cpp:573-579).
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field

import numpy as np

from ..index.kmerfilter import KmerFilter
from ..index.seq import NT4_TABLE
from .opts import BWA_MIN_RDLEN, BWA_MODE_COMPREAD, BWA_TYPE_NO_MATCH
from .rand import MersenneRandom


@dataclass(slots=True)
class Read:
    """bwa_seq_t equivalent."""

    name: str = ""
    seq: np.ndarray | None = None  # REVERSED encoded read (codes 0..4)
    rseq: np.ndarray | None = None  # reverse-complement encoded read
    qual: np.ndarray | None = None  # phred+33 bytes, original orientation
    len: int = 0
    full_len: int = 0
    clip_len: int = 0
    filtered: bool = False
    # alignment results
    aln: list = field(default_factory=list)
    n_aln: int = 0
    multi: list = field(default_factory=list)
    n_multi: int = 0
    sa: int = 0
    pos: int = 0
    strand: int = 0
    type: int = BWA_TYPE_NO_MATCH
    c1: int = 0
    c2: int = 0
    n_mm: int = 0
    n_gapo: int = 0
    n_gape: int = 0
    score: int = 0
    mapQ: int = 0
    seQ: int = 0
    extra_flag: int = 0
    cigar: list | None = None
    n_cigar: int = 0
    md: str = ""
    nm: int = 0

    def forward_codes(self) -> np.ndarray:
        """The read in original orientation (seq is stored reversed)."""
        return self.seq[: self.len][::-1]


def seq_reverse(codes: np.ndarray, is_comp: bool) -> np.ndarray:
    out = codes[::-1].copy()
    if is_comp:
        mask = out < 4
        out[mask] = 3 - out[mask]
    return out


def bwa_trim_read(trim_qual: int, p: Read) -> int:
    """bwaseqio.c:75-88: BWA-style 3' quality trimming."""
    if trim_qual < 1 or p.qual is None:
        return 0
    s = 0
    mx = 0
    max_l = p.len - 1
    for l in range(p.len - 1, BWA_MIN_RDLEN - 2, -1):
        s += trim_qual - (int(p.qual[l]) - 33)
        if s < 0:
            break
        if s > mx:
            mx = s
            max_l = l
    p.clip_len = p.len = max_l + 1
    return p.full_len - p.len


class FastqReader:
    """Streaming FASTQ(.gz) reader yielding raw (name, seq, qual) or
    skipping records (for downsampling)."""

    def __init__(self, path: str):
        self._fh = gzip.open(path, "rt") if path.endswith(".gz") else open(path)

    def next_record(self) -> tuple[str, str, str] | None:
        h = self._fh.readline()
        if not h:
            return None
        seq = self._fh.readline().strip()
        sep = self._fh.readline()
        qual = self._fh.readline().strip() if sep.startswith("+") else ""
        name = h[1:].split()[0] if h.startswith("@") else h.strip()
        return name, seq, qual

    def skip_record(self) -> bool:
        h = self._fh.readline()
        if not h:
            return False
        self._fh.readline()
        sep = self._fh.readline()
        if sep.startswith("+"):
            self._fh.readline()
        return True

    def close(self):
        self._fh.close()


class NativeFastqReader:
    """C++ fast path: gzip decode + nt4 encode + trim + k-mer filter in
    native code (see native/fastq_loader.cpp); yields the same Read
    objects as the Python path."""

    MAX_LEN = 1024
    NAME_STRIDE = 256

    def __init__(self, path: str, kmer: KmerFilter | None, trim_qual: int,
                 thresh: int):
        import ctypes

        from ..native import get_lib

        self._lib = get_lib()
        if self._lib is None:
            raise RuntimeError("native loader unavailable")
        self._h = self._lib.fq_open(path.encode())
        if not self._h:
            raise FileNotFoundError(path)
        self.trim_qual = trim_qual
        self._bitmap_ptrs = None
        self.thresh = 0
        if kmer is not None and thresh > 0:
            bitmaps = kmer.byte_bitmaps()
            arr = (ctypes.c_void_p * 6)(
                *[b.ctypes.data_as(ctypes.c_void_p) for b in bitmaps])
            self._bitmap_ptrs = arr
            self._bitmaps_keepalive = bitmaps
            self.thresh = thresh

    _scratch = None  # reused across batches: fresh 600MB of anonymous
    # memory per batch costs more in page faults than the decode itself

    def read_batch(self, n_needed: int, is_comp: bool) -> list[Read]:
        import ctypes

        ML, NS_ = self.MAX_LEN, self.NAME_STRIDE
        if self._scratch is None or self._scratch[0].shape[0] < n_needed:
            self._scratch = (np.empty((n_needed, ML), dtype=np.uint8),
                             np.empty((n_needed, ML), dtype=np.uint8),
                             np.empty(n_needed, dtype=np.int32),
                             np.empty(n_needed, dtype=np.int32),
                             np.empty(n_needed, dtype=np.uint8),
                             ctypes.create_string_buffer(n_needed * NS_))
        seqs, quals, lens, full_lens, filt, names = self._scratch
        n = self._lib.fq_read_batch(
            self._h, n_needed, ML, self.trim_qual,
            self._bitmap_ptrs, self.thresh,
            seqs.ctypes.data_as(ctypes.c_void_p),
            quals.ctypes.data_as(ctypes.c_void_p),
            lens.ctypes.data_as(ctypes.c_void_p),
            full_lens.ctypes.data_as(ctypes.c_void_p),
            filt.ctypes.data_as(ctypes.c_void_p),
            names, NS_)
        if n < 0:
            raise RuntimeError("malformed FASTQ input")
        raw = names.raw  # single copy; per-item .raw slicing copies 67MB each
        out: list[Read] = []
        # uniform-length fast path (the overwhelmingly common case):
        # batch-compute forward/reversed/revcomp arrays once and hand each
        # Read row views (no downstream code mutates these in place)
        if n and int(full_lens[:n].min()) == int(full_lens[:n].max()) \
                and int(lens[:n].min()) == int(lens[:n].max()) \
                and int(lens[0]) == int(full_lens[0]):
            L = int(lens[0])
            fwd = np.ascontiguousarray(seqs[:n, :L])
            rev = np.ascontiguousarray(fwd[:, ::-1])
            if is_comp:
                rvc = np.where(rev < 4, 3 - rev, rev).astype(np.uint8)
            else:
                rvc = rev
            qrows = np.ascontiguousarray(quals[:n, :L])
            has_q = qrows.max(axis=1) > 0
            find_nul = raw.index
            for i in range(n):
                p = Read()
                p.full_len = p.clip_len = p.len = L
                p.qual = qrows[i] if has_q[i] else None
                base = i * NS_
                p.name = raw[base:find_nul(b"\0", base)].decode()
                if filt[i]:
                    p.filtered = True
                    p.seq = fwd[i]
                else:
                    p.rseq = rvc[i]
                    p.seq = rev[i]
                out.append(p)
            return out
        for i in range(n):
            p = Read()
            fl = int(full_lens[i])
            tl = int(lens[i])
            p.full_len = fl
            p.clip_len = p.len = tl
            codes = seqs[i, :fl].copy()
            p.qual = quals[i, :fl].copy()
            if not p.qual.any():
                p.qual = None
            base = i * NS_
            p.name = raw[base:raw.index(b"\0", base)].decode()
            if filt[i]:
                p.filtered = True
                p.seq = codes
            else:
                p.rseq = seq_reverse(codes[:tl], is_comp)
                p.seq = np.concatenate(
                    [seq_reverse(codes[:tl], False), codes[tl:]])
            out.append(p)
        return out

    def close(self):
        self._lib.fq_close(self._h)


def read_batch(reader: FastqReader, kmer: KmerFilter | None, n_needed: int,
               mode: int, trim_qual: int, frac: float, seed: int
               ) -> list[Read]:
    """bwa_read_seq_with_hash (BwtMapper.cpp:344-466): one batch of reads,
    downsampled, trimmed, filtered, encoded + reversed."""
    rng = MersenneRandom(seed) if frac < 1.0 else None
    is_comp = bool(mode & BWA_MODE_COMPREAD)
    out: list[Read] = []
    while len(out) < n_needed:
        if rng is not None and rng.next() > frac:
            if not reader.skip_record():
                break
            continue
        rec = reader.next_record()
        if rec is None:
            break
        name, seq_s, qual_s = rec
        p = Read()
        p.full_len = p.clip_len = p.len = len(seq_s)
        codes = NT4_TABLE[np.frombuffer(seq_s.encode("ascii"), dtype=np.uint8)].copy()
        p.seq = codes
        p.qual = (np.frombuffer(qual_s.encode("ascii"), dtype=np.uint8).copy()
                  if qual_s else None)
        if trim_qual >= 1:
            bwa_trim_read(trim_qual, p)
        if name.endswith("/1") or name.endswith("/2"):
            name = name[:-2]
        p.name = name
        if kmer is not None and kmer.thresh != 0 and not kmer.is_read_kept(
                codes[: p.len]):
            p.filtered = True
            out.append(p)
            continue
        p.rseq = seq_reverse(codes[: p.len], is_comp)
        p.seq = np.concatenate([seq_reverse(codes[: p.len], False),
                                codes[p.len:]])
        out.append(p)
    return out
