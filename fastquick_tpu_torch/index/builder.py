"""Reduced-reference index build + load.

Equivalent of the reference's BwtIndexer::BuildIndex/LoadIndex
(src/BwtIndexer.cpp:716-762, :803-837) with a TPU-native artifact layout:

- ``.FASTQuick.fa``      reduced-reference FASTA  (same contract)
- ``.FASTQuick.fa.{SelectedSite.vcf,bed,gc,dbSNP.subset.vcf,param}``
  (same contract as the reference)
- ``.FASTQuick.fa.{pac,ann,amb}``  bwa-compatible packed reference +
  annotations (bns_dump format, libbwa/bntseq.c:57-86), kept for
  diffability
- ``.FASTQuick.fa.index.npz``  packed numpy arrays for the device:
  forward+reverse FM index (2-bit BWT words, Occ checkpoints, full SA),
  pac codes, contig table -- replaces .bwt/.rbwt/.sa/.rsa binaries
- ``.FASTQuick.fa.kmer.npz``   sparse k-mer filter keys -- replaces the
  3 GiB raw .rollhash dump

N bases are filled with the same deterministic lrand48(seed=11) stream as
the reference (src/BwtIndexer.cpp:846-850, :949-952) so alignments are
bit-comparable.
"""

from __future__ import annotations

import os
from bisect import bisect_right as _bisect_right
from dataclasses import dataclass

import numpy as np

from ..io.fasta import build_fai
from ..utils.logging import notice
from .fmindex import FMIndex
from .kmerfilter import KmerFilter, KmerFilterBuilder
from .seq import NT4_TABLE, Lrand48


@dataclass
class ContigInfo:
    name: str  # "chr:pos@ref/alt[|L]"
    offset: int  # base offset in the packed text
    length: int
    chrom: str
    pos: int  # 1-based marker position on the real genome
    ref: str
    alt: str
    is_long: bool

    @classmethod
    def parse(cls, name: str, offset: int, length: int) -> "ContigInfo":
        base = name
        is_long = False
        if base.endswith("|L"):
            base = base[:-2]
            is_long = True
        chrom, rest = base.split(":", 1)
        pos_s, alleles = rest.split("@", 1)
        ref, alt = alleles.split("/", 1)
        return cls(name=name, offset=offset, length=length, chrom=chrom,
                   pos=int(pos_s), ref=ref, alt=alt, is_long=is_long)


@dataclass
class ReducedIndex:
    """In-memory index: everything align-time needs."""

    fm_fwd: FMIndex
    fm_rev: FMIndex  # over reverse(T) -- for prefix-direction search
    text: np.ndarray  # N-filled codes (uint8, 0..3)
    contigs: list[ContigInfo]
    contig_offsets: np.ndarray  # (n_contigs,) int64
    kmer: KmerFilter
    ambs: list[tuple[int, int, str]]  # (offset, len, amb char)

    @property
    def l_pac(self) -> int:
        return len(self.text)

    _offsets_list: list | None = None

    def coor_pac2real(self, pac_pos: int) -> tuple[int, int]:
        """pac offset -> (contig index, offset within contig);
        equivalent of bns_coor_pac2real (libbwa/bntseq.c)."""
        if self._offsets_list is None:
            # bisect on a Python list beats np.searchsorted call overhead
            # for the one-lookup-per-read hot path
            self._offsets_list = self.contig_offsets.tolist()
        i = _bisect_right(self._offsets_list, pac_pos) - 1
        return i, pac_pos - self._offsets_list[i]


def build_index(new_ref: str, thresh: int = 3) -> ReducedIndex:
    """Build everything from the written reduced-reference FASTA.

    Mirrors BuildIndex: reads .FASTQuick.fa line pairs, populates the
    k-mer filter (both strands, alleles parsed from the contig name),
    packs the text with lrand48 N filling, builds forward+reverse FM
    indexes, dumps artifacts."""
    notice("Packing reduced reference + building k-mer filter...")
    kb = KmerFilterBuilder(thresh=thresh)
    contigs: list[ContigInfo] = []
    codes_list: list[np.ndarray] = []
    ambs: list[tuple[int, int, str]] = []
    rng = Lrand48(11)
    offset = 0
    with open(new_ref) as fh:
        while True:
            name_line = fh.readline()
            if not name_line:
                break
            name = name_line.strip()[1:]
            seq = fh.readline().strip()
            at = name.find("@")
            alleles = (name[at + 1], name[at + 3])
            kb.add_seq(seq, alleles)
            c = NT4_TABLE[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)].copy()
            # record N holes (runs of the same ambiguity character,
            # Fa2Pac lasts-comparison semantics) and fill with lrand48
            n_idx = np.nonzero(c >= 4)[0]
            if len(n_idx):
                run_start = None
                last_char = None
                for i in map(int, n_idx):
                    ch = seq[i]
                    if run_start is not None and i == prev + 1 and ch == last_char:
                        prev = i
                    else:
                        if run_start is not None:
                            ambs.append((offset + run_start, prev - run_start + 1,
                                         last_char))
                        run_start = i
                        prev = i
                        last_char = ch
                ambs.append((offset + run_start, prev - run_start + 1, last_char))
                for i in map(int, n_idx):
                    c[i] = rng.next() & 3
            contigs.append(ContigInfo.parse(name, offset, len(seq)))
            codes_list.append(c)
            offset += len(seq)
    text = np.concatenate(codes_list) if codes_list else np.zeros(0, np.uint8)
    notice("Reduced reference: %d contigs, %d bp", len(contigs), len(text))

    notice("Building forward FM-index...")
    fm_fwd = FMIndex.build(text)
    notice("Building reverse FM-index...")
    fm_rev = FMIndex.build(text[::-1].copy())
    kmer = kb.finalize()

    idx = ReducedIndex(
        fm_fwd=fm_fwd, fm_rev=fm_rev, text=text, contigs=contigs,
        contig_offsets=np.array([ci.offset for ci in contigs], dtype=np.int64),
        kmer=kmer, ambs=ambs)
    save_index(new_ref, idx)
    return idx


def save_index(new_ref: str, idx: ReducedIndex) -> None:
    _dump_bns(new_ref, idx)
    _dump_pac(new_ref + ".pac", idx.text)
    build_fai(new_ref, new_ref + ".fai")
    d = {}
    for tag, fm in (("f", idx.fm_fwd), ("r", idx.fm_rev)):
        d[f"{tag}_bwt_words"] = fm.bwt_words
        d[f"{tag}_occ"] = fm.occ
        d[f"{tag}_sa"] = fm.sa
        d[f"{tag}_C"] = fm.C
        d[f"{tag}_primary"] = np.int64(fm.primary)
    d["text"] = idx.text
    d["contig_offsets"] = idx.contig_offsets
    d["contig_lengths"] = np.array([c.length for c in idx.contigs], dtype=np.int64)
    d["contig_names"] = np.array([c.name for c in idx.contigs])
    # uncompressed: load_index mmaps the members (zip-stored arrays are
    # page-aligned), so align startup pays no decompress/copy cost
    np.savez(new_ref + ".index.npz", **d)
    idx.kmer.save_npz(new_ref + ".kmer.npz")
    from .kmerfilter import CACHE_MIN_KEYS

    if sum(len(k) for k in idx.kmer.keys) >= CACHE_MIN_KEYS:
        # dense-bitmap cache (the reference's .rollhash equivalent):
        # built once here so every align run just mmaps it
        idx.kmer.cache_path = new_ref + ".rollhash.bin"
        idx.kmer.write_bitmap_cache(idx.kmer.cache_path)
        notice("Rollhash bitmap cache written to %s.rollhash.bin", new_ref)
    notice("Index artifacts written to %s.{index,kmer}.npz", new_ref)


def load_index(new_ref: str) -> ReducedIndex:
    d = np.load(new_ref + ".index.npz", allow_pickle=False,
                mmap_mode="r")
    fms = {}
    for tag in ("f", "r"):
        text_len = len(d["text"])
        fms[tag] = FMIndex(
            n=text_len, primary=int(d[f"{tag}_primary"]),
            C=np.asarray(d[f"{tag}_C"]),
            bwt_words=np.asarray(d[f"{tag}_bwt_words"]),
            occ=np.asarray(d[f"{tag}_occ"]), sa=np.asarray(d[f"{tag}_sa"]))
    names = d["contig_names"]
    offsets = d["contig_offsets"]
    lengths = d["contig_lengths"]
    contigs = [ContigInfo.parse(str(n), int(o), int(l))
               for n, o, l in zip(names, offsets, lengths)]
    kmer = KmerFilter.load_npz(new_ref + ".kmer.npz")
    return ReducedIndex(fm_fwd=fms["f"], fm_rev=fms["r"],
                        text=d["text"], contigs=contigs,
                        contig_offsets=offsets.astype(np.int64),
                        kmer=kmer, ambs=[])


def _dump_pac(path: str, text: np.ndarray) -> None:
    """bwa .pac format: 2-bit packed, base j of byte b at bits (3-j%4)*2,
    trailing byte = l_pac % 4 (extra zero byte first if l_pac % 4 == 0)."""
    n = len(text)
    n_bytes = (n + 3) // 4
    padded = np.zeros(n_bytes * 4, dtype=np.uint8)
    padded[:n] = text
    packed = ((padded[0::4] << 6) | (padded[1::4] << 4)
              | (padded[2::4] << 2) | padded[3::4]).astype(np.uint8)
    with open(path, "wb") as fh:
        fh.write(packed.tobytes())
        if n % 4 == 0:
            fh.write(b"\x00")
        fh.write(bytes([n % 4]))


def _dump_bns(new_ref: str, idx: ReducedIndex) -> None:
    """bns_dump text formats (libbwa/bntseq.c:57-86)."""
    with open(new_ref + ".ann", "w") as fh:
        fh.write(f"{idx.l_pac} {len(idx.contigs)} 11\n")
        for c in idx.contigs:
            n_ambs = sum(1 for a in idx.ambs
                         if c.offset <= a[0] < c.offset + c.length)
            fh.write(f"0 {c.name} (null)\n")
            fh.write(f"{c.offset} {c.length} {n_ambs}\n")
    with open(new_ref + ".amb", "w") as fh:
        fh.write(f"{idx.l_pac} {len(idx.contigs)} {len(idx.ambs)}\n")
        for off, ln, ch in idx.ambs:
            fh.write(f"{off} {ln} {ch}\n")


def write_param(new_ref: str, ref_path: str, target_region_path: str,
                dbsnp_path: str, num_long: int, num_short: int,
                flank_short: int, flank_long: int) -> None:
    """The .param metadata file (reference src/FASTQuick.cpp:140-152).
    Paths are absolutized so align/merge work from any cwd."""
    ref_path = os.path.abspath(ref_path)
    dbsnp_path = os.path.abspath(dbsnp_path)
    if target_region_path != "Empty":
        target_region_path = os.path.abspath(target_region_path)
    with open(new_ref + ".param", "w") as fh:
        fh.write(f"REFERENCE_PATH\t{ref_path}\n")
        fh.write(f"TARGET_REGION_PATH\t{target_region_path}\n")
        fh.write(f"DBSNP_VCF_PATH\t{dbsnp_path}\n")
        fh.write(f"NUM_VAR_LONG\t{num_long}\n")
        fh.write(f"NUM_VAR_SHORT\t{num_short}\n")
        fh.write(f"SHORT_FLANK_LENGTH\t{flank_short}\n")
        fh.write(f"LONG_FLANK_LENGTH\t{flank_long}\n")


def read_param(new_ref: str) -> dict:
    """Strict ordered parse (reference src/FASTQuick.cpp:365-467)."""
    out: dict[str, str | int] = {}
    int_keys = {"NUM_VAR_LONG", "NUM_VAR_SHORT", "SHORT_FLANK_LENGTH",
                "LONG_FLANK_LENGTH"}
    with open(new_ref + ".param") as fh:
        for line in fh:
            k, v = line.rstrip("\n").split("\t", 1)
            out[k] = int(v) if k in int_keys else v
    return out
