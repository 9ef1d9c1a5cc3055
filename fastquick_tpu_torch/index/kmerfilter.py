"""Rolling-hash k-mer read filter (host build; device query in ops/kmer.py).

Equivalent of the reference's six "shrinkage" bitmap tables
(src/BwtIndexer.h:262-315 KmerShrinkage; src/BwtIndexer.cpp:555-567
InitializeRollHashTable, :611-713 AddSeq2HashCore, :871-885 Fa2Pac calls).

Each 32-mer of every marker flank (forward AND reverse-complement strand,
with BOTH alleles substituted at the center base) is projected six ways
down to 32 bits and the corresponding bit set in a 4^16-bit (512 MiB)
bitmap per projection.  A read passes if its first three non-overlapping
32-mers accumulate >= thresh (default 3) table hits
(IsReadInHashByCountMoreChunck, src/BwtIndexer.cpp:~498-516).

Faithfully replicated quirks:
- N bases feed the 64-bit rolling kmer as value 4 (0b100), spilling a bit
  into the neighboring base's field -- same arithmetic here.
- The reverse-complement strand substitutes the UNCOMPLEMENTED ref/alt
  characters at the center index (Fa2Pac passes the same `alleles` vector
  for both strands).
- Kmers are inserted for the left flank, 32 center-spanning windows per
  allele, then the right flank continuing from the LAST allele's register.

Storage: we persist the SET of distinct projected values per table (sorted
uint32) rather than raw 512 MiB bitmaps -- markers set only ~10M of 4.3G
bits, so this is ~100x smaller on disk; bitmaps are reconstructed on load.
"""

from __future__ import annotations

import numpy as np

from .seq import NT4_TABLE, reverse_complement_str

KMER_SIZE = 32
N_TABLES = 6
TABLE_BITS = 32  # projected space is 2^32 bits = 512 MiB bitmap
DEFAULT_THRESH = 3
#: below this many total keys the dense-bitmap disk cache is skipped
CACHE_MIN_KEYS = 2_000_000

_U64 = np.uint64


def kmer_shrinkage(kmers: np.ndarray, table: int) -> np.ndarray:
    """Vectorized 6-way projection (BwtIndexer.h:262-315)."""
    k = kmers.astype(_U64)
    if table == 0:
        return ((k & _U64(0xFFFFFFFF00000000)) >> _U64(32)).astype(np.uint32)
    if table == 1:
        return (k & _U64(0xFFFFFFFF)).astype(np.uint32)
    if table == 2:
        return (((k & _U64(0xFFFF000000000000)) >> _U64(32))
                | (k & _U64(0xFFFF))).astype(np.uint32)
    if table == 3:
        return ((k & _U64(0x0000FFFFFFFF0000)) >> _U64(16)).astype(np.uint32)
    if table == 4:
        return (((k & _U64(0xFFFF000000000000)) >> _U64(32))
                | ((k & _U64(0xFFFF0000)) >> _U64(16))).astype(np.uint32)
    if table == 5:
        return (((k & _U64(0xFFFF00000000)) >> _U64(16))
                | (k & _U64(0xFFFF))).astype(np.uint32)
    raise ValueError(f"unknown table {table}")


def _register_stream(codes: np.ndarray) -> np.ndarray:
    """Sequential rolling register after consuming codes[0..i] for each i
    (64-bit wraparound), matching ``datum = (datum << 2) | v``."""
    c = codes.astype(_U64)
    regs = np.zeros(len(c), dtype=_U64)
    r = _U64(0)
    for i in range(len(c)):
        r = _U64((int(r) << 2 | int(c[i])) & 0xFFFFFFFFFFFFFFFF)
        regs[i] = r
    return regs


def register_stream_vec(codes: np.ndarray) -> np.ndarray:
    """Vectorized register stream: reg[i] = OR_j codes[i-j] << 2j for
    j < 32.  Exactly equals the sequential ``(reg << 2) | v`` fold: each
    value v <= 4 spans bits [0,2], so v's bit 2 overlaps the next value's
    field, and the sequential semantics combine overlaps with OR -- we
    replicate with OR-accumulation (uint64 shift wraparound included)."""
    n = len(codes)
    c = codes.astype(_U64)
    acc = np.zeros(n, dtype=_U64)
    for j in range(KMER_SIZE):
        # value consumed j steps ago sits at bit offset 2j
        sh = np.zeros(n, dtype=_U64)
        sh[j:] = c[: n - j] << _U64(2 * j)
        acc |= sh
    return acc


class KmerFilterBuilder:
    """Accumulates raw 64-bit kmers; projects + dedupes at finalize.

    (Deferring the 6-way projection/dedupe to one vectorized
    np.unique per table replaces ~25k Python set insertions per contig;
    10k-marker index build: minutes -> seconds.)"""

    #: raw-kmer buffer compaction threshold (memory cap ~8 x 8B = 64 MB)
    _COMPACT_AT = 8_000_000

    def __init__(self, thresh: int = DEFAULT_THRESH):
        self.thresh = thresh
        self._chunks: list[np.ndarray] = []
        self._n_pending = 0

    def _compact(self) -> None:
        if len(self._chunks) > 1:
            self._chunks = [np.unique(np.concatenate(self._chunks))]
        self._n_pending = 0  # counts entries appended since last compact

    def add_seq(self, seq: str, alleles: tuple[str, str]) -> None:
        """AddSeq2Hash for one contig: forward strand then reverse
        complement, same (uncomplemented) alleles for both."""
        self._add_one_strand(seq, alleles)
        self._add_one_strand(reverse_complement_str(seq), alleles)

    def _add_one_strand(self, seq: str, alleles: tuple[str, str]) -> None:
        codes = NT4_TABLE[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]
        n = len(codes)
        half = n // 2
        if n < KMER_SIZE:
            return
        regs = register_stream_vec(codes)
        inserted: list[np.ndarray] = []
        # Phase 1: kmers ending at i for i in [31, half)
        end = min(half, n)
        if end > KMER_SIZE - 1:
            inserted.append(regs[KMER_SIZE - 1:end])
        # Phase 2: per allele, windows ending at [half, half+32)
        last_regs = None
        base_reg = int(regs[half - 1]) if half >= 1 else 0
        for al in alleles:
            r = base_reg
            vals = []
            for j in range(half, min(half + KMER_SIZE, n)):
                v = int(NT4_TABLE[ord(al)]) if j == half else int(codes[j])
                r = ((r << 2) | v) & 0xFFFFFFFFFFFFFFFF
                vals.append(r)
            last_regs = (r, min(half + KMER_SIZE, n))
            if vals:
                inserted.append(np.array(vals, dtype=_U64))
        # Phase 3: continue from last allele's register.  The 64-bit
        # register holds exactly the last 32 pushed values (the seed --
        # allele included -- is fully shifted out after KMER_SIZE
        # pushes, and every window here starts past the allele slot),
        # so the continuation equals the plain stream registers: a
        # slice of the regs already computed above replaces the
        # per-base python fold (~220 iterations/strand at 501bp flanks,
        # the largest k-mer registration cost in the index build).
        if last_regs is not None:
            _r, start = last_regs
            if start < n:
                inserted.append(regs[start:n])
        if not inserted:
            return
        kmers = np.concatenate(inserted)
        self._chunks.append(kmers)
        self._n_pending += len(kmers)
        if self._n_pending >= self._COMPACT_AT:
            self._compact()

    def finalize(self) -> "KmerFilter":
        self._compact()
        all_k = (self._chunks[0] if self._chunks
                 else np.zeros(0, dtype=_U64))
        keys = [np.unique(kmer_shrinkage(all_k, t)) for t in range(N_TABLES)]
        return KmerFilter(keys=keys, thresh=self.thresh)


class KmerFilter:
    """Query-side filter: six sorted key arrays (or bitmaps on device)."""

    def __init__(self, keys: list[np.ndarray], thresh: int = DEFAULT_THRESH):
        self.keys = keys
        self.thresh = thresh

    def count_kmer_hits(self, kmer: int) -> int:
        k = np.array([kmer], dtype=_U64)
        hits = 0
        for t in range(N_TABLES):
            proj = kmer_shrinkage(k, t)[0]  # keep the keys' dtype: a
            # python-int needle makes searchsorted cast the whole array
            i = np.searchsorted(self.keys[t], proj.astype(self.keys[t].dtype))
            if i < len(self.keys[t]) and self.keys[t][i] == proj:
                hits += 1
        return hits

    def is_read_kept(self, codes: np.ndarray) -> bool:
        """IsReadFiltered inverted: True if the read PASSES (>= thresh
        accumulated hits over its first 3 non-overlapping 32-mers).
        The reference reads 3 chunks unconditionally (buffer over-read for
        short reads); we clamp to the chunks fully inside the read."""
        n_chunk = min(3, len(codes) // KMER_SIZE)
        count = 0
        for i in range(n_chunk):
            chunk = codes[i * KMER_SIZE:(i + 1) * KMER_SIZE]
            kmer = 0
            for v in chunk:
                kmer = ((kmer << 2) | int(v)) & 0xFFFFFFFFFFFFFFFF
            count += self.count_kmer_hits(kmer)
            if count >= self.thresh:
                return True
        return False

    _byte_bitmaps: list[np.ndarray] | None = None
    #: when set (by load_npz / the index builder), dense bitmaps are
    #: persisted here once and mmap'd thereafter -- the moral equivalent
    #: of the reference's `.rollhash` dump (BwtIndexer.cpp DumpRollHash),
    #: kept as a rebuildable cache beside the sparse-key artifact.
    cache_path: str | None = None

    def _build_table(self, t: int) -> np.ndarray:
        """Dense 512 MiB byte bitmap for one projection table."""
        from ..native import get_sw_lib

        lib = get_sw_lib()
        table = np.zeros(1 << 29, dtype=np.uint8)
        # sorted keys -> near-sequential writes (TLB/page-fault friendly;
        # the unsorted scatter is ~10x slower on 512 MiB tables)
        k = np.sort(self.keys[t]).astype(np.uint32, copy=False)
        if lib is not None:
            import ctypes

            lib.set_bits(table.ctypes.data_as(ctypes.c_void_p),
                         k.ctypes.data_as(ctypes.c_void_p), len(k))
        else:
            np.bitwise_or.at(table, k >> 3,
                             (np.uint8(1) << (k & 7)).astype(np.uint8))
        return table

    def write_bitmap_cache(self, cache: str) -> None:
        """Build and persist the 6 dense bitmaps (3 GiB, one table
        resident at a time); atomic via temp-file rename."""
        import os

        tmp = f"{cache}.tmp{os.getpid()}"
        with open(tmp, "wb") as fh:
            for t in range(N_TABLES):
                self._build_table(t).tofile(fh)
        os.replace(tmp, cache)

    def byte_bitmaps(self) -> list[np.ndarray]:
        """Dense per-table byte bitmaps in the reference's layout
        (bit k at byte k>>3, bit k&7) for the native filter; 6 x 512 MiB.
        File-backed (mmap) when ``cache_path`` is set: page-cache pages
        are shared across processes/runs and are not subject to the
        anonymous-memory reclaim that makes per-process rebuilds slow."""
        if self._byte_bitmaps is not None:
            return self._byte_bitmaps
        import os

        cache = self.cache_path
        if cache is not None and os.path.exists(cache) \
                and os.path.getsize(cache) == N_TABLES << 29:
            # mmap the existing cache without ever touching the (lazily
            # loaded) key arrays
            mm = np.memmap(cache, dtype=np.uint8, mode="r")
            self._byte_bitmaps = [mm[t << 29:(t + 1) << 29]
                                  for t in range(N_TABLES)]
            return self._byte_bitmaps
        if cache is not None \
                and sum(len(k) for k in self.keys) < CACHE_MIN_KEYS:
            cache = None  # tiny (test) indexes: not worth 3 GiB on disk
        if cache is not None:
            self.write_bitmap_cache(cache)
            mm = np.memmap(cache, dtype=np.uint8, mode="r")
            self._byte_bitmaps = [mm[t << 29:(t + 1) << 29]
                                  for t in range(N_TABLES)]
        else:
            self._byte_bitmaps = [self._build_table(t)
                                  for t in range(N_TABLES)]
        return self._byte_bitmaps

    def bitmaps_uint32(self) -> np.ndarray:
        """Dense (6, 2^27) uint32 bitmap array for device HBM (3 GiB).

        The device word layout (bit k at word k>>5, bit k&31) is exactly
        the little-endian uint32 VIEW of the byte layout (bit k at byte
        k>>3, bit k&7): for k = 32w + r, the byte index within the word
        is r>>3 and the in-byte bit r&7, and LE word bit = 8*(r>>3) +
        (r&7) = r.  So this is a zero-build reinterpretation of
        byte_bitmaps() (mmap'd from the rollhash cache when present)."""
        rows = [np.asarray(b).view(np.uint32) for b in self.byte_bitmaps()]
        return np.stack(rows)

    def save_npz(self, path: str) -> None:
        # uncompressed: the 32-bit hash keys are high-entropy (deflate
        # saves little) and uncompressed members load without a copy pass
        np.savez(path, thresh=np.int32(self.thresh),
                 **{f"keys{t}": self.keys[t] for t in range(N_TABLES)})

    @classmethod
    def load_npz(cls, path: str) -> "KmerFilter":
        d = np.load(path)
        kf = cls(keys=_LazyKeys(d), thresh=int(d["thresh"]))
        if path.endswith(".kmer.npz"):
            kf.cache_path = path[:-len(".kmer.npz")] + ".rollhash.bin"
        return kf


class _LazyKeys:
    """List-like over the 6 key arrays, materialized per table on first
    access (with the rollhash bitmap cache present, align runs never
    touch them at all)."""

    def __init__(self, npz):
        self._d = npz
        self._cache: list = [None] * N_TABLES

    def __getitem__(self, t: int) -> np.ndarray:
        if self._cache[t] is None:
            self._cache[t] = self._d[f"keys{t}"]
        return self._cache[t]

    def __len__(self) -> int:
        return N_TABLES

    def __iter__(self):
        return (self[t] for t in range(N_TABLES))
