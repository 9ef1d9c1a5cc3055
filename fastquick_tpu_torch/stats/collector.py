"""QC statistics accumulation + the 14 output files.

Equivalent of the reference's StatCollector (src/StatCollector.cpp):
- AddAlignment pair dispatch (:950-1101) with contig-bridge demotion,
  X/Y contig status counting, ProcessPairStatus insert-size rows
  (:623-948) incl. PCR-duplicate detection, and AddSingleAlignment
  (:424-621) with mapQ>=20 gate, reduced->real coordinate mapping and
  per-CIGAR-op base accounting.
- RecoverRefseqByMDandCigar (:92-206) reconstructing the reference from
  MD+CIGAR.
- RestoreVcfSites (:1742-1839): markers + GC records + dbSNP subset,
  flank regions trimmed by read_len*0.65 (FLANK_EDGE).
- ProcessCore outputs (:1858-2483): .DepthDist .GCDist .EmpRepDist
  .EmpCycleDist .Raw/AdjustedInsertSizeDist .SexChromInfo .Pileup .vcf
  .FASTQ.csv .Sequence.csv .Summary.

Float formatting matches C++ iostream defaults (6 significant digits).

This host-side collector is the behavioral reference; the TPU path
accumulates the same tensors (depth/Q20/Q30 per site, qual/cycle
histograms, per-marker pileups) as device-side scatter-adds and feeds
them into this module's output writers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..align.opts import (
    BWA_MODE_IL13,
    BWA_TYPE_NO_MATCH,
    SAM_FSR,
    SAM_FSU,
    GapOpt,
)
from ..align.refine import FROM_D, FROM_I, FROM_M, FROM_S, pos_end
from ..index.builder import ReducedIndex
from ..io.gc import read_gc_records
from ..io.region import RegionList
from ..io.vcf import VcfReader, VcfRecord, normalize_chrom
from ..utils.logging import notice, warning

FLANK_EDGE = 0.65
INSERT_SIZE_LIMIT = 4096


def fmt(v) -> str:
    """C++ ostream default double formatting (6 significant digits)."""
    if isinstance(v, int):
        return str(v)
    if math.isnan(v):
        return "-nan" if math.copysign(1, v) < 0 else "nan"
    if math.isinf(v):
        return "inf" if v > 0 else "-inf"
    return f"{v:.6g}"


def phred(x: float) -> float:
    return -10 * math.log10(x)


def rev_phred(x: float) -> float:
    return math.pow(10.0, x / -10.0)


@dataclass
class FileStat:
    """FileStatCollector (StatCollector.h:46-62)."""

    file_name1: str = ""
    file_name2: str = ""
    num_read: int = 0
    num_base: int = 0
    total_filtered: int = 0
    bwa_unmapped: int = 0
    total_mapq: int = 0
    total_retained: int = 0


def cigar_str(p) -> str:
    if p.cigar:
        return "".join(f"{ln}{'MIDS'[op]}" for op, ln in p.cigar)
    return f"{p.len}M"


def is_partial_align(p) -> bool:
    if not p.cigar:
        return False
    return any(op == FROM_S for op, _ in p.cigar)


def recover_refseq_by_md_and_cigar(read_seq: str, md: str,
                                   cigar: list | None) -> str:
    """StatCollector.cpp:92-206."""
    md = md.upper()
    if (not any(c in md for c in "ATCGN")) and _leading_int(md) == len(read_seq):
        return read_seq
    if cigar:
        parts = []
        rpos = 0
        for op, cl in cigar:
            if op == FROM_M:
                parts.append(read_seq[rpos:rpos + cl])
                rpos += cl
            elif op in (FROM_S, FROM_I):
                rpos += cl
            # FROM_D: nothing
        ref_seq = "".join(parts)
    else:
        ref_seq = read_seq

    out = list(ref_seq)
    last = 0
    total_len = 0
    i = 0
    while i < len(md):
        ch = md[i]
        if ch.isdigit():
            i += 1
            continue
        if ch == "^":
            length = int(md[last:i] or 0)
            total_len += length
            start_on_read = total_len
            i += 1
            tmp = []
            while i < len(md) and not md[i].isdigit():
                tmp.append(md[i])
                i += 1
                total_len += 1
            out = out[:start_on_read] + tmp + out[start_on_read:]
            last = i
        else:
            length = int(md[last:i] or 0) + 1
            total_len += length
            out[total_len - 1] = ch
            last = i + 1
            i += 1
    return "".join(out)


def _leading_int(s: str) -> int:
    num = ""
    for ch in s:
        if ch.isdigit():
            num += ch
        else:
            break
    return int(num) if num else 0


_FWD_MAP = np.frombuffer(b"ACGTN", dtype=np.uint8)
_RC_MAP = np.frombuffer(b"TGCAN", dtype=np.uint8)


def _materialize(p) -> tuple[np.ndarray, np.ndarray]:
    """Read bases (ASCII codes) + qualities (phred ints) in reference
    orientation (AddSingleAlignment :437-460)."""
    if p.strand == 0:
        seq_np = _FWD_MAP[p.seq[: p.full_len]]
        qual = p.qual[: p.full_len].astype(np.int64) - 33
    else:
        seq_np = _RC_MAP[p.seq[: p.full_len][::-1]]
        qual = p.qual[: p.full_len][::-1].astype(np.int64) - 33
    return seq_np, qual


def _parse_mismatch_md(md: str, length: int):
    """Mismatch (offset, ref-letter) pairs of a deletion-free MD string
    ("12A3T0..."), or None if the string has any other shape (the
    caller then takes the generic per-read path).  For cigar-less
    full-length reads the reference-relative offset equals the
    read-relative one, so the slab can place the mismatches directly."""
    out = []
    off = 0
    i = 0
    nn = len(md)
    while i < nn:
        j = i
        while j < nn and md[j].isdigit():
            j += 1
        if j == i:
            return None
        off += int(md[i:j])
        i = j
        if i < nn:
            c = md[i]
            if c == "^":
                return None
            out.append((off, c.upper()))
            off += 1
            i += 1
    if off != length:
        return None
    return out


class StatCollector:
    def __init__(self):
        self._sites = None  # DenseSites, built lazily (after target join)
        # per marker pileups
        self.seq_vec: list[str] = []
        self.qual_vec: list[list[int]] = []
        self.cycle_vec: list[list[int]] = []
        self.maq_vec: list[list[int]] = []
        self.strand_vec: list[list[bool]] = []
        self.vcf_rec_vec: list[VcfRecord] = []
        self.vcf_table: dict[str, dict[int, int]] = {}
        self.dbsnp_table: dict[str, set[int]] = {}
        self.depth_dist = np.zeros(1024, dtype=np.int64)
        self.cycle_dist = np.zeros(512, dtype=np.int64)
        self.gc_dist = np.zeros(256, dtype=np.int64)
        self.pos_num = np.zeros(101, dtype=np.int64)
        self.emp_rep_dist = np.zeros(256, dtype=np.int64)
        self.mis_emp_rep_dist = np.zeros(256, dtype=np.int64)
        self.emp_cycle_dist = np.zeros(256, dtype=np.int64)
        self.mis_emp_cycle_dist = np.zeros(256, dtype=np.int64)
        self.insert_size_dist = [0] * INSERT_SIZE_LIMIT
        # deferred dense-site scatters (see _update_regular/flush_dense)
        self._pend_idx: list[np.ndarray] = []
        self._pend_bq: list[np.ndarray] = []
        self._pend_cycles: list[np.ndarray] = []
        self._pend_mis_bq: list[np.ndarray] = []
        self._pend_mis_cycles: list[np.ndarray] = []
        # deferred eligible single alignments: (read, chrom, real_start);
        # drained (in order) by flush_dense
        self._queue: list[tuple] = []
        self._marker_pos: dict[str, np.ndarray] = {}
        # per-chrom list of (start_pos, per-position GC values) segments
        self.gc: dict[str, list[tuple[int, np.ndarray]]] = {}
        self.duplicate_table: set[str] = set()
        self.contig_status: dict[str, list[int]] = {}
        # [overlapped, fully_included, pair_overlapped, fully_included_paired]
        self.fsc_vec: list[FileStat] = []
        self.target_region = RegionList()
        self.flank_region = RegionList()
        self.total_region_size = 0
        self.ref_genome_size = 0
        self.ref_N_size = 0
        self.num_xy_marker = 0
        self.num_short_marker = 0
        self.num_long_marker = 0
        self.num_pcr_dup = 0
        self.num_pair_reads = 0
        self.num_base_mapped = 0
        self.num_pos_cov = 0
        self.num_pos_cov2 = 0
        self.num_pos_cov5 = 0
        self.num_pos_cov10 = 0

    # ---- setup ----

    def restore_vcf_sites(self, ref_path: str, opt: GapOpt) -> None:
        """RestoreVcfSites (:1742-1839)."""
        chopped = int(math.floor(opt.read_len * FLANK_EDGE + 0.5))
        gc_records = read_gc_records(ref_path + ".gc")
        with VcfReader(ref_path + ".SelectedSite.vcf") as reader:
            for n, rec in enumerate(reader):
                self.vcf_rec_vec.append(rec)
                chrom = normalize_chrom(rec.chrom)
                pos = rec.pos
                self.vcf_table.setdefault(chrom, {})[pos] = len(self.vcf_rec_vec) - 1
                gcs = gc_records[n]
                tmp_pos = pos - (len(gcs) - 1) // 2
                self.gc.setdefault(chrom, []).append(
                    (tmp_pos, gcs.astype(np.int64)))
                if chrom in ("X", "Y"):
                    self.num_xy_marker += 1
                    self.flank_region.add(chrom, pos - opt.flank_len + chopped,
                                          pos + opt.flank_len - chopped)
                elif rec.id.endswith("L"):
                    self.num_long_marker += 1
                    self.flank_region.add(chrom,
                                          pos - opt.flank_long_len + chopped,
                                          pos + opt.flank_long_len - chopped)
                else:
                    self.num_short_marker += 1
                    self.flank_region.add(chrom, pos - opt.flank_len + chopped,
                                          pos + opt.flank_len - chopped)
                self.seq_vec.append("")
                self.qual_vec.append([])
                self.cycle_vec.append([])
                self.maq_vec.append([])
                self.strand_vec.append([])
        self.flank_region.collapse()
        notice("Input %d markers with short flank region", self.num_short_marker)
        notice("Input %d markers with long flank region", self.num_long_marker)
        notice("Total flank region size:%d", self.flank_region.total_size())
        with VcfReader(ref_path + ".dbSNP.subset.vcf") as reader:
            for rec in reader:
                chrom = normalize_chrom(rec.chrom)
                self.dbsnp_table.setdefault(chrom, set()).add(rec.pos)

    def set_genome_size(self, total: int, total_n: int) -> None:
        self.ref_genome_size = total
        self.ref_N_size = total_n

    def set_target_region(self, path: str) -> None:
        self.target_region.read_region_list(path, collapse=True)
        self.flank_region = self.flank_region.join_inner(self.target_region)
        self._sites = None  # rebuild over the joined regions

    def add_fsc(self, fsc: FileStat) -> None:
        self.fsc_vec.append(fsc)

    # ---- dense site table ----

    @property
    def sites(self):
        if self._sites is None:
            from .sites import DenseSites

            if not self.flank_region.collapsed:
                self.flank_region.collapse()
            # RegionList holds CLOSED 1-based [s, e] (reference
            # semantics); DenseSites wants half-open 0-based [s, e)
            s = DenseSites({ch: [(s0 - 1, e0) for s0, e0 in ivs]
                            for ch, ivs in self.flank_region.regions.items()})
            for chrom, segs in self.gc.items():
                # positions = per-segment runs, built with one repeat
                # instead of len(segs) aranges
                starts = np.array([t for t, _ in segs], dtype=np.int64)
                lens = np.array([len(g) for _, g in segs], dtype=np.int64)
                total = int(lens.sum())
                base = np.repeat(starts - np.concatenate(
                    [[0], np.cumsum(lens)[:-1]]), lens)
                pos = base + np.arange(total, dtype=np.int64)
                val = np.concatenate([g for _, g in segs])
                s.fill_from_positions(chrom, pos, val, "gc")
            for chrom, posset in self.dbsnp_table.items():
                s.fill_from_positions(
                    chrom, np.fromiter(posset, np.int64, len(posset)),
                    None, "dbsnp")
            self._sites = s
        return self._sites

    # ---- accumulation (vectorized per M-segment) ----

    def _update_marker(self, tmp_cycle: int, site: int, cl: int, strand: int,
                       chrom: str, seq: str, qual: np.ndarray, mapq: int,
                       rel_read: int) -> None:
        tbl = self.vcf_table.get(chrom)
        if tbl is None:
            return
        mpos = self._marker_pos.get(chrom)
        if mpos is None:
            mpos = np.array(sorted(tbl), dtype=np.int64)
            self._marker_pos[chrom] = mpos
        lo = np.searchsorted(mpos, site)
        hi = np.searchsorted(mpos, site + cl)
        sign = -1 if strand else 1
        for p in mpos[lo:hi]:
            off = int(p) - site
            idx = tbl[int(p)]
            self.seq_vec[idx] += (seq[rel_read + off] if isinstance(seq, str)
                                  else chr(seq[rel_read + off]))
            self.qual_vec[idx].append(int(qual[rel_read + off]))
            self.cycle_vec[idx].append(tmp_cycle + sign * off)
            self.maq_vec[idx].append(mapq + 33)
            self.strand_vec[idx].append(bool(strand))

    def _update_regular(self, seq: np.ndarray, qual: np.ndarray,
                        ref_seq: np.ndarray, chrom: str, site: int,
                        strand: int, match_len: int, tmp_cycle: int,
                        rel_read: int, rel_ref: int) -> int:
        """Vectorized UpdateInfoVecAtRegularSite: one segment's in-region
        bases become numpy scatter-adds on the dense site table."""
        positions, idx = self.sites.index_range(chrom, site, site + match_len)
        if len(idx) == 0:
            return 0
        off = positions - site  # segment-relative offsets (int64)
        bq = qual[rel_read + off]
        sign = -1 if strand else 1
        cycles = tmp_cycle + sign * off
        rb = seq[rel_read + off]
        fb = ref_seq[rel_ref + off]
        N = ord("N")
        mism = (rb != N) & (fb != rb) & (fb != N) & ~self.sites.dbsnp[idx]
        # deferred: one np.add.at per batch instead of per read (the
        # scatters are commutative sums; flush_dense() applies them)
        self._pend_idx.append(idx)
        self._pend_bq.append(bq)
        self._pend_cycles.append(cycles)
        if mism.any():
            self._pend_mis_bq.append(bq[mism])
            self._pend_mis_cycles.append(cycles[mism])
        return len(idx)

    def flush_dense(self) -> None:
        """Apply the deferred dense-site scatter-adds accumulated by
        _update_regular.  Must run before anything reads sites.depth/
        q20/q30 or the empirical distributions (process_core,
        save_shard); the driver also calls it at each batch end."""
        self._drain_queue()
        # np.bincount instead of np.add.at: same commutative sums, ~10x
        # faster on the ~10M-element batch scatters
        if self._pend_idx:
            idx = np.concatenate(self._pend_idx)
            bq = np.concatenate(self._pend_bq)
            cycles = np.concatenate(self._pend_cycles)
            depth = self.sites.depth
            S = len(depth)
            # one composite bincount instead of three (plus two masked
            # extractions): key = site + S * qual-tier (0 / >=Q20 / >=Q30)
            tier = (bq >= 20).astype(np.int64) + (bq >= 30)
            c = np.bincount(idx + tier * S, minlength=3 * S)
            c0, c1, c2 = c[:S], c[S:2 * S], c[2 * S:]
            q30 = c2
            q20 = c1 + c2
            depth += c0 + q20
            self.sites.q20 += q20
            self.sites.q30 += q30
            self.emp_rep_dist += np.bincount(
                bq, minlength=len(self.emp_rep_dist))
            self.emp_cycle_dist += np.bincount(
                cycles, minlength=len(self.emp_cycle_dist))
            self._pend_idx.clear()
            self._pend_bq.clear()
            self._pend_cycles.clear()
        if self._pend_mis_bq:
            self.mis_emp_rep_dist += np.bincount(
                np.concatenate(self._pend_mis_bq),
                minlength=len(self.mis_emp_rep_dist))
            self.mis_emp_cycle_dist += np.bincount(
                np.concatenate(self._pend_mis_cycles),
                minlength=len(self.mis_emp_cycle_dist))
            self._pend_mis_bq.clear()
            self._pend_mis_cycles.clear()
        dev = getattr(self, "dense_device", None)
        if dev is not None:
            dev.flush(self)

    def add_single_alignment(self, idx: ReducedIndex, p, opt: GapOpt) -> bool:
        """AddSingleAlignment (:424-621) eligibility gate.  The per-base
        accounting is deferred to _drain_queue (invoked by flush_dense),
        which batch-vectorizes the pure-match majority; the return value
        only depends on the mapQ>=20 / mapped gates (:429-433), so
        AddAlignment's control flow is unchanged by deferral."""
        if p.type == BWA_TYPE_NO_MATCH or p.mapQ < 20:
            return False
        seqid, _ = idx.coor_pac2real(p.pos)
        contig = idx.contigs[seqid]
        pos = p.pos - contig.offset + 1
        flank = opt.flank_long_len if contig.is_long else opt.flank_len
        read_real_start = contig.pos - flank + pos - 1
        self._queue.append((p, normalize_chrom(contig.chrom),
                            read_real_start))
        return True

    def _apply_single(self, p, chrom: str, read_real_start: int) -> None:
        """Per-read body of AddSingleAlignment (:437-618): coordinate
        walk over the CIGAR with marker + regular-site accounting."""
        seq_np, qual = _materialize(p)
        seq = seq_np  # ASCII bytes; str only materialized when MD needs it

        md = p.md
        if p.cigar is None and md.isdigit():
            # full-length match, no mismatches/deletions: ref == read
            ref_np = seq_np
        else:
            ref_seq = recover_refseq_by_md_and_cigar(
                seq_np.tobytes().decode("ascii"), md, p.cigar)
            ref_np = np.frombuffer(ref_seq.encode("ascii"), dtype=np.uint8)

        site = read_real_start
        tmp_cycle = p.full_len - 1 if p.strand else 0
        rel_read = 0
        rel_ref = 0
        if p.cigar:
            for op, cl in p.cigar:
                sign = -1 if p.strand else 1
                if op == FROM_M:
                    self._update_marker(tmp_cycle, site, cl, p.strand, chrom,
                                        seq, qual, p.mapQ, rel_read)
                    self._update_regular(seq_np, qual, ref_np, chrom, site,
                                         p.strand, cl, tmp_cycle, rel_read,
                                         rel_ref)
                    site += cl
                    tmp_cycle += cl * sign
                    rel_read += cl
                    rel_ref += cl
                elif op == FROM_S:
                    tmp_cycle += cl * sign
                    rel_read += cl
                elif op == FROM_D:
                    site += cl
                    rel_ref += cl
                elif op == FROM_I:
                    tmp_cycle += cl * sign
                    rel_read += cl
        else:
            self._update_marker(tmp_cycle, site, p.len, p.strand, chrom, seq,
                                qual, p.mapQ, rel_read)
            self._update_regular(seq_np, qual, ref_np, chrom, site, p.strand,
                                 p.len, tmp_cycle, rel_read, rel_ref)

    _VEC_CHUNK = 16384  # rows per vectorized slab (caps transient memory)

    def _drain_queue(self) -> None:
        """Apply the deferred AddSingleAlignment bodies.  Marker-pileup
        appends run in original read order (the .Pileup strings are
        order-sensitive); the dense-site scatters of pure-match reads
        (cigar None, digit MD: ref == read, one M segment) are computed
        as one masked 2-D pass per chromosome -- commutative sums, so
        batching them is output-identical."""
        q = self._queue
        if not q:
            return
        self._queue = []
        n = len(q)
        simple = np.zeros(n, dtype=bool)
        dev_take = np.zeros(n, dtype=bool)
        dev = getattr(self, "dense_device", None)
        site0 = np.empty(n, dtype=np.int64)
        rlen = np.empty(n, dtype=np.int64)
        groups: dict[str, list[int]] = {}
        # pure-mismatch reads joining the slab: row -> kept mismatch
        # offsets (read bases != N, ref letters != N; the dbsnp and
        # in-region gates apply vectorized inside the slab)
        mm_offs: dict[int, np.ndarray] = {}
        for i, (p, chrom, site) in enumerate(q):
            site0[i] = site
            rlen[i] = p.len
            if p.cigar is None and p.len == p.full_len:
                if p.md.isdigit():
                    simple[i] = True
                elif dev is None:
                    # ungapped untrimmed read with mismatches: the slab
                    # computes the same depth/q20/q30/emp sums; only the
                    # mis_emp_* contributions need the MD's mismatch
                    # offsets (ref == read everywhere else)
                    mm = _parse_mismatch_md(p.md, p.len)
                    if mm is not None:
                        fl = p.full_len
                        keep = [off for off, refc in mm
                                if refc != "N"
                                and (p.seq[fl - 1 - off] if p.strand
                                     else p.seq[off]) != 4]
                        simple[i] = True
                        if keep:
                            mm_offs[i] = np.asarray(keep, dtype=np.int64)
                # device dense backend handles every ungapped untrimmed
                # read (mismatches included: the device text-vs-read
                # compare equals the MD-recovered reference for these);
                # marker pileup strings stay host-side in arrival order
                if dev is not None:
                    dev_take[i] = True
                    simple[i] = False
            groups.setdefault(chrom, []).append(i)

        sites = self.sites
        marker_hit = np.zeros(n, dtype=bool)
        vec_rows: dict[str, np.ndarray] = {}
        for chrom, idl in groups.items():
            idxs = np.asarray(idl, dtype=np.int64)
            tbl = self.vcf_table.get(chrom)
            if tbl is not None:
                mpos = self._marker_pos.get(chrom)
                if mpos is None:
                    mpos = np.array(sorted(tbl), dtype=np.int64)
                    self._marker_pos[chrom] = mpos
                lo = np.searchsorted(mpos, site0[idxs])
                hi = np.searchsorted(mpos, site0[idxs] + rlen[idxs])
                marker_hit[idxs] = hi > lo
            srows = idxs[simple[idxs]]
            c = sites._fast.get(chrom)
            if c is None or len(srows) == 0:
                continue
            starts, ends = c[0], c[1]
            s0 = site0[srows] - 1
            e0 = s0 + rlen[srows]  # exclusive 0-based read end
            # overlapped-region range [lo_r, hi_r]: only reads touching
            # >= 2 regions need the per-read walk; a read that merely
            # STARTS before its single region (partial overlap) is
            # handled by the slab's positional mask
            lo_r = np.searchsorted(ends, s0, side="right")
            hi_r = np.searchsorted(starts, e0, side="left") - 1
            multi = hi_r > lo_r
            vec_rows[chrom] = srows[~multi]
            simple[srows[multi]] = False

        # in-order pass: marker pileups + the non-simple remainder
        for i, (p, chrom, site) in enumerate(q):
            if simple[i] or dev_take[i]:
                if marker_hit[i]:
                    seq_np, qual = _materialize(p)
                    tmp_cycle = p.full_len - 1 if p.strand else 0
                    self._update_marker(tmp_cycle, site, p.len, p.strand,
                                        chrom, seq_np, qual, p.mapQ, 0)
                if dev_take[i]:
                    dev.add(p)
            else:
                self._apply_single(p, chrom, site)

        # vectorized regular-site scatters for the pure-match majority
        for chrom, rows in vec_rows.items():
            starts, ends, offsets = sites._fast[chrom]
            for lo in range(0, len(rows), self._VEC_CHUNK):
                rs = rows[lo:lo + self._VEC_CHUNK]
                m = len(rs)
                s0 = site0[rs] - 1
                L = rlen[rs]
                # candidate region: the first one ending after the read
                # start (== the single overlapped region for rows the
                # multi gate kept; rows overlapping nothing mask to 0)
                iv = np.searchsorted(ends, s0, side="right")
                has = iv < len(starts)
                ivc = np.clip(iv, 0, len(starts) - 1)
                Lmax = int(L.max())
                ar = np.arange(Lmax, dtype=np.int64)
                posm = s0[:, None] + ar[None, :]
                inreg = ((ar[None, :] < L[:, None])
                         & (posm >= starts[ivc][:, None])
                         & (posm < ends[ivc][:, None])
                         & has[:, None])
                dense = (offsets[ivc] - starts[ivc])[:, None] + posm
                Q = np.zeros((m, Lmax), dtype=np.int64)
                strands = np.zeros(m, dtype=bool)
                # grouped quals: stack rows of equal length and reverse
                # the strand rows in one vectorized pass (the per-row
                # assignment loop was ~40% of this function's self time)
                by_len: dict[int, list[int]] = {}
                quals: list = [None] * m
                mis_r: list[np.ndarray] = []
                mis_o: list[np.ndarray] = []
                for k in range(m):
                    ri = rs[k]
                    p = q[ri][0]
                    strands[k] = bool(p.strand)
                    quals[k] = p.qual
                    by_len.setdefault(int(L[k]), []).append(k)
                    offs = mm_offs.get(int(ri))
                    if offs is not None:
                        mis_r.append(np.full(len(offs), k, dtype=np.int64))
                        mis_o.append(offs)
                for l, ks in by_len.items():
                    G = np.stack([quals[k][:l] for k in ks]).astype(np.int64)
                    ksa = np.asarray(ks, dtype=np.int64)
                    rev = strands[ksa]
                    Q[ksa, :l] = np.where(rev[:, None], G[:, ::-1], G)
                Q -= 33
                cyc = np.where(strands[:, None],
                               (L - 1)[:, None] - ar[None, :], ar[None, :])
                self._pend_idx.append(dense[inreg])
                self._pend_bq.append(Q[inreg])
                self._pend_cycles.append(cyc[inreg])
                if mis_r:
                    mr = np.concatenate(mis_r)
                    mo = np.concatenate(mis_o)
                    sel = inreg[mr, mo]
                    mr, mo = mr[sel], mo[sel]
                    dmis = dense[mr, mo]
                    ok = ~self.sites.dbsnp[dmis]
                    self._pend_mis_bq.append(Q[mr, mo][ok])
                    self._pend_mis_cycles.append(cyc[mr, mo][ok])

    def process_pair_status(self, idx: ReducedIndex, p, q, type_: str,
                            fout) -> int:
        """ProcessPairStatus (:623-948).  type_ in FirstOnly/SecondOnly/Both."""
        max_insert = -1
        max_insert2 = -1
        flag1 = flag2 = 0
        if p is not None:
            flag1 = p.extra_flag | (SAM_FSU if p.type == BWA_TYPE_NO_MATCH else 0)
            if p.strand:
                flag1 |= SAM_FSR
        if q is not None:
            flag2 = q.extra_flag | (SAM_FSU if q.type == BWA_TYPE_NO_MATCH else 0)
            if q.strand:
                flag2 |= SAM_FSR

        def clips(r):
            cl_l = cl_r = 0
            if r.cigar:
                if r.cigar[0][0] == FROM_S:
                    cl_l = r.cigar[0][1]
                if r.cigar[-1][0] == FROM_S:
                    cl_r = r.cigar[-1][1]
            return cl_l, cl_r

        def contig_of(r):
            sid, _ = idx.coor_pac2real(r.pos)
            return sid, idx.contigs[sid]

        if type_ == "SecondOnly":
            sid_q, cq = contig_of(q)
            cl3, cl4 = clips(q)
            if q.mapQ > 0:
                if q.strand:
                    if cq.offset + cq.length >= (q.pos - cl3) + q.len:
                        max_insert2 = (q.pos - cl3) + q.len - cq.offset
                    else:
                        return 2
                    status = "RevOnly"
                else:
                    if (q.pos - cl3) >= cq.offset:
                        max_insert = cq.offset + cq.length - (q.pos - cl3)
                    else:
                        return 2
                    status = "FwdOnly"
                fout.write(f"{q.name}\t{max_insert}\t{max_insert2}\t-1\t*\t*\t"
                           f"{flag1}\t0\t*\t{cq.name}\t"
                           f"{q.pos - cq.offset + 1}\t{flag2}\t{q.len}\t"
                           f"{cigar_str(q)}\t{status}\n")
                return 0
            fout.write(f"{q.name}\t{max_insert}\t{max_insert2}\t-1\t*\t*\t"
                       f"{flag1}\t0\t*\t{cq.name}\t{q.pos - cq.offset + 1}\t"
                       f"{flag2}\t{q.len}\t{cigar_str(q)}\tLowQual\n")
            return 2
        if type_ == "FirstOnly":
            sid_p, cp = contig_of(p)
            cl1, cl2 = clips(p)
            if p.mapQ > 0:
                if p.strand:
                    if cp.offset + cp.length >= (p.pos - cl1) + p.len:
                        max_insert2 = (p.pos - cl1) + p.len - cp.offset
                    else:
                        return 2
                    status = "RevOnly"
                else:
                    if (p.pos - cl1) >= cp.offset:
                        max_insert = cp.offset + cp.length - (p.pos - cl1)
                    else:
                        return 2
                    status = "FwdOnly"
                fout.write(f"{p.name}\t{max_insert}\t{max_insert2}\t-1\t"
                           f"{cp.name}\t{p.pos - cp.offset + 1}\t{flag1}\t"
                           f"{p.len}\t{cigar_str(p)}\t*\t*\t{flag2}\t0\t*\t"
                           f"{status}\n")
                return 0
            fout.write(f"{p.name}\t{max_insert}\t{max_insert2}\t-1\t{cp.name}\t"
                       f"{p.pos - cp.offset + 1}\t{flag1}\t{p.len}\t"
                       f"{cigar_str(p)}\t*\t*\t{flag2}\t0\t*\tLowQual\n")
            return 2

        # Both
        sid_p, cp = contig_of(p)
        sid_q, cq = contig_of(q)
        cl1, cl2 = clips(p)
        cl3, cl4 = clips(q)
        if (not p.strand) and q.strand and p.pos < q.pos:  # FR
            if (p.pos - cl1) >= cp.offset:
                max_insert = cp.offset + cp.length - (p.pos - cl1)
            if cq.offset + cq.length >= (q.pos - cl3) + q.len:
                max_insert2 = (q.pos - cl3) + q.len - cq.offset
        elif (not q.strand) and p.strand and q.pos < p.pos:  # FR rotated
            if (q.pos - cl3) >= cq.offset:
                max_insert = cq.offset + cq.length - (q.pos - cl3)
            if cp.offset + cp.length >= (p.pos - cl1) + p.len:
                max_insert2 = (p.pos - cl1) + p.len - cp.offset
        else:
            fout.write(self._pair_row(p, q, cp, cq, flag1, flag2, max_insert,
                                      max_insert2, -1, "NotPair"))
            return 0

        if max_insert >= INSERT_SIZE_LIMIT:
            max_insert = INSERT_SIZE_LIMIT - 1
        if max_insert2 >= INSERT_SIZE_LIMIT:
            max_insert2 = INSERT_SIZE_LIMIT - 1

        if sid_p != sid_q:
            self.insert_size_dist[0] += 1
            fout.write(self._pair_row(p, q, cp, cq, flag1, flag2, max_insert,
                                      max_insert2, -1, "NotPair"))
            return 0

        if p.mapQ > 0 and q.mapQ > 0:
            no_clip = False
            prop_pair = False
            actual_insert = -1
            start = end = 0
            status = "PartialPair"
            if (not p.strand) and q.strand and p.pos < q.pos:
                start = p.pos - cl1
                end = q.pos - cl3 + q.len
                actual_insert = end - start
                if cl1 == 0 and cl4 == 0:
                    no_clip = True
            elif (not q.strand) and p.strand and q.pos < p.pos:
                start = q.pos - cl3
                end = p.pos - cl1 + p.len
                actual_insert = end - start
                if cl3 == 0 and cl2 == 0:
                    no_clip = True
            if max_insert != -1 and max_insert2 != -1:
                status = "PropPair"
                prop_pair = True
            self.insert_size_dist[actual_insert] += 1
            fout.write(self._pair_row(p, q, cp, cq, flag1, flag2, max_insert,
                                      max_insert2, actual_insert, status))
            if prop_pair and no_clip:
                key = f"{sid_p}:{start}:{end}"
                if key in self.duplicate_table:
                    self.num_pcr_dup += 2
                else:
                    self.duplicate_table.add(key)
                self.num_pair_reads += 2
            return 0
        fout.write(self._pair_row(p, q, cp, cq, flag1, flag2, max_insert,
                                  max_insert2, -1, "LowQual"))
        return 2

    @staticmethod
    def _pair_row(p, q, cp, cq, flag1, flag2, mi, mi2, actual, status) -> str:
        return (f"{p.name}\t{mi}\t{mi2}\t{actual}\t{cp.name}\t"
                f"{p.pos - cp.offset + 1}\t{flag1}\t{p.len}\t{cigar_str(p)}\t"
                f"{cq.name}\t{q.pos - cq.offset + 1}\t{flag2}\t{q.len}\t"
                f"{cigar_str(q)}\t{status}\n")

    def _contig_stat(self, name: str) -> list[int]:
        return self.contig_status.setdefault(name, [0, 0, 0, 0])

    def add_alignment(self, idx: ReducedIndex, p, q, opt: GapOpt, fout,
                      fsc: FileStat) -> int:
        """AddAlignment (:950-1101).  Returns 0/1/2; updates
        fsc.total_mapq like the C total_add_failed counter."""
        seqid = seqid2 = 0
        if p is not None and p.type != BWA_TYPE_NO_MATCH:
            j = pos_end(p) - p.pos
            seqid, _ = idx.coor_pac2real(p.pos)
            if p.pos + j - idx.contigs[seqid].offset > idx.contigs[seqid].length:
                p.type = BWA_TYPE_NO_MATCH
        if q is not None and q.type != BWA_TYPE_NO_MATCH:
            j2 = pos_end(q) - q.pos
            seqid2, _ = idx.coor_pac2real(q.pos)
            if q.pos + j2 - idx.contigs[seqid2].offset > idx.contigs[seqid2].length:
                q.type = BWA_TYPE_NO_MATCH

        qname = idx.contigs[seqid2].name
        if p is None or p.type == BWA_TYPE_NO_MATCH:
            if q is not None and self.add_single_alignment(idx, q, opt):
                if "Y" in qname or "X" in qname:
                    cs = self._contig_stat(qname)
                    cs[0] += 1
                    if not is_partial_align(q):
                        cs[1] += 1
                self.process_pair_status(idx, p, q, "SecondOnly", fout)
                fsc.total_mapq += 1
                return 1
            fsc.total_mapq += 2
            return 0

        pname = idx.contigs[seqid].name
        if q is None or q.type == BWA_TYPE_NO_MATCH:
            if self.add_single_alignment(idx, p, opt):
                if "Y" in pname or "X" in pname:
                    cs = self._contig_stat(pname)
                    cs[0] += 1
                    if not is_partial_align(p):
                        cs[1] += 1
                self.process_pair_status(idx, p, q, "FirstOnly", fout)
                fsc.total_mapq += 1
                return 1
            fsc.total_mapq += 2
            return 0

        # both aligned
        if "Y" in qname or "X" in qname:
            csq = self._contig_stat(qname)
            csp = self._contig_stat(pname)
            if is_partial_align(p):
                if is_partial_align(q):
                    csq[0] += 1
                else:
                    csq[0] += 1
                    csq[1] += 1
                if pname == qname:
                    csq[2] += 1
                csp[0] += 1
            else:
                if is_partial_align(q):
                    csq[0] += 1
                    if pname == qname:
                        csq[2] += 1
                else:
                    csq[0] += 1
                    csq[1] += 1
                    if pname == qname:
                        csq[2] += 1
                        csq[3] += 1
                csp[0] += 1
                csp[1] += 1

        if self.process_pair_status(idx, p, q, "Both", fout) != 1 or opt.cal_dup:
            ok_p = self.add_single_alignment(idx, p, opt)
            ok_q = self.add_single_alignment(idx, q, opt)
            if ok_p and ok_q:
                return 2
            if ok_p or ok_q:
                fsc.total_mapq += 1
                return 1
            fsc.total_mapq += 2
            return 0
        fsc.total_mapq += 2
        return 0

    # ---- outputs ----

    def process_core(self, prefix: str, opt: GapOpt) -> None:
        self.flush_dense()
        self.get_depth_dist(prefix, opt)
        self.get_gc_dist(prefix)
        self.get_emp_rep_dist(prefix)
        self.get_emp_cycle_dist(prefix)
        self.get_insert_size_dist(prefix)
        self.get_sex_chrom_info(prefix)
        self.get_pileup(prefix, opt)
        self.summary_output(prefix)
        self.get_vcf(prefix)

    def get_depth_dist(self, prefix: str, opt: GapOpt) -> None:
        s = self.sites
        covered = s.depth > 0
        depth_c = s.depth[covered]
        self.num_base_mapped += int(depth_c.sum())
        np.add.at(self.depth_dist, np.clip(depth_c, 0, 1023), 1)
        gc_c = s.gc[covered].astype(np.int64)
        np.add.at(self.gc_dist, gc_c, depth_c)
        np.add.at(self.pos_num, np.clip(gc_c, 0, 100), 1)
        for i in range(1, len(self.depth_dist)):
            self.num_pos_cov += self.depth_dist[i]
            if i >= 2:
                self.num_pos_cov2 += self.depth_dist[i]
            if i >= 5:
                self.num_pos_cov5 += self.depth_dist[i]
            if i >= 10:
                self.num_pos_cov10 += self.depth_dist[i]
        if len(self.target_region) == 0:
            chopped = int(math.floor(opt.read_len * FLANK_EDGE + 0.5))
            self.total_region_size = (
                ((opt.flank_len - chopped) * 2 + 1) * self.num_short_marker
                + ((opt.flank_long_len - chopped) * 2 + 1) * self.num_long_marker
                + ((opt.flank_len - chopped) * 2 + 1) * self.num_xy_marker)
        else:
            self.total_region_size = self.flank_region.total_size()
        with open(prefix + ".DepthDist", "w") as fout:
            self.depth_dist[0] = self.total_region_size - self.num_pos_cov
            for i, v in enumerate(self.depth_dist):
                fout.write(f"{i}\t{v}\n")

    def get_gc_dist(self, prefix: str) -> None:
        with open(prefix + ".GCDist", "w") as fout:
            mean_depth = (self.num_base_mapped / self.num_pos_cov
                          if self.num_pos_cov else float("nan"))
            for i in range(101):
                fout.write(f"{i}\t{self.gc_dist[i]}\t{self.pos_num[i]}\t")
                if self.pos_num[i] == 0:
                    fout.write("0")
                else:
                    fout.write(fmt((self.gc_dist[i] / self.pos_num[i]) / mean_depth))
                fout.write("\n")

    def get_emp_rep_dist(self, prefix: str) -> None:
        with open(prefix + ".EmpRepDist", "w") as fout:
            for i in range(256):
                v = (0 if self.emp_rep_dist[i] == 0 else
                     phred((self.mis_emp_rep_dist[i] + 1)
                           / (self.emp_rep_dist[i] + 2)))
                fout.write(f"{i}\t{self.mis_emp_rep_dist[i]}\t"
                           f"{self.emp_rep_dist[i]}\t{fmt(v)}\n")

    def get_emp_cycle_dist(self, prefix: str) -> None:
        with open(prefix + ".EmpCycleDist", "w") as fout:
            prev_qual = 0.0
            for i in range(256):
                if self.mis_emp_cycle_dist[i] == 0:
                    v = prev_qual
                else:
                    v = phred((self.mis_emp_cycle_dist[i] + 1e-6)
                              / (self.emp_cycle_dist[i] + 1e-6))
                fout.write(f"{i + 1}\t{self.mis_emp_cycle_dist[i]}\t"
                           f"{self.emp_cycle_dist[i]}\t{fmt(v)}\t"
                           f"{self.cycle_dist[i]}\n")
                if self.mis_emp_cycle_dist[i] != 0:
                    v = phred((self.mis_emp_cycle_dist[i] + 1e-6)
                              / (self.emp_cycle_dist[i] + 1e-6))
                    prev_qual = v

    def get_insert_size_dist(self, prefix: str) -> None:
        from .insertsize import InsertSizeEstimator

        est = InsertSizeEstimator()
        est.input_insert_size_table(prefix + ".InsertSizeTable", "FwdOnly")
        f1 = est.update_weight()
        est.re_init()
        est.input_insert_size_table(prefix + ".InsertSizeTable", "RevOnly")
        f2 = est.update_weight()
        with open(prefix + ".AdjustedInsertSizeDist", "w") as fout:
            for i in range(len(f1)):
                fout.write(f"{i}\t{fmt(f1[i] + f2[i])}\n")
        with open(prefix + ".RawInsertSizeDist", "w") as fout:
            for i, v in enumerate(self.insert_size_dist):
                fout.write(f"{i}\t{v}\n")

    def get_sex_chrom_info(self, prefix: str) -> None:
        with open(prefix + ".SexChromInfo", "w") as fout:
            for name, cs in self.contig_status.items():
                fout.write(f"{name}\t{cs[0]}\t{cs[1]}\t{cs[2]}\t{cs[3]}\n")

    def get_pileup(self, prefix: str, opt: GapOpt) -> None:
        qualoffset = 64 if opt.mode & BWA_MODE_IL13 else 33
        with open(prefix + ".Pileup", "w") as fout:
            for chrom in sorted(self.vcf_table):
                for pos in sorted(self.vcf_table[chrom]):
                    k = self.vcf_table[chrom][pos]
                    if not self.seq_vec[k]:
                        continue
                    bases = "".join(
                        b.upper() if s else b.lower()
                        for b, s in zip(self.seq_vec[k], self.strand_vec[k]))
                    quals = "".join(chr(qv + qualoffset) for qv in self.qual_vec[k])
                    maqs = "".join(chr(m) for m in self.maq_vec[k])
                    cycles = ",".join(str(c) for c in self.cycle_vec[k])
                    fout.write(f"{chrom}\t{pos}\t.\t{len(self.strand_vec[k])}\t"
                               f"{bases}\t{quals}\t{maqs}\t{cycles}\n")

    def get_vcf(self, prefix: str) -> None:
        import time

        with open(prefix + ".vcf", "w") as fout:
            fout.write("##fileformat=VCFv4.2\n")
            fout.write(f"##fileDate={time.strftime('%Y%m%d')}\n")
            fout.write("##source=VerifyBamID2\n")
            fout.write('##INFO=<ID=AF,Number=A,Type=Float,Description="Allele '
                       'Frequency, for each ALT allele, in the same order as '
                       'listed">\n')
            fout.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
            fout.write('##FORMAT=<ID=GP,Number=1,Type=String,Description="Genotype">\n')
            fout.write('##FORMAT=<ID=PL,Number=G,Type=Integer,Description='
                       '"Normalized, Phred-scaled likelihoods for genotypes '
                       'as defined in the VCF specification">\n')
            fout.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT"
                       "\tIntendedSample\n")
            for chrom in sorted(self.vcf_table):
                for pos in sorted(self.vcf_table[chrom]):
                    k = self.vcf_table[chrom][pos]
                    rec = self.vcf_rec_vec[k]
                    af_s = rec.info_dict().get("AF")
                    if af_s is None:
                        warning("%s:%d has no AF field, skipped!", rec.chrom,
                                rec.pos)
                        continue
                    if not self.seq_vec[k]:
                        continue
                    af = rec.get_af()
                    gl0, gl1, gl2 = self._cal_likelihood(
                        self.seq_vec[k], self.qual_vec[k], rec.ref[0],
                        rec.alt[0])
                    prior = [phred((1 - af) ** 2), phred(2 * af * (1 - af)),
                             phred(af * af)]
                    post = [prior[0] + gl0, prior[1] + gl1, prior[2] + gl2]
                    s = phred(rev_phred(post[0]) + rev_phred(post[1])
                              + rev_phred(post[2]))
                    post = [math.floor(pv - s + 0.5) for pv in post]
                    if post[0] < post[1]:
                        gt = "0/0" if post[0] < post[2] else "1/1"
                    elif post[1] < post[2]:
                        gt = "0/1"
                    else:
                        gt = "1/1"
                    fout.write(f"{rec.chrom}\t{rec.pos}\t{rec.id}\t{rec.ref}\t"
                               f"{rec.alt}\t{rec.qual}\t{rec.filter}\t"
                               f"AF={af_s};AC={len(self.seq_vec[k])}\t"
                               f"GT:PL:GP\t{gt}:{fmt(gl0)},{fmt(gl1)},"
                               f"{fmt(gl2)}:{fmt(post[0])},{fmt(post[1])},"
                               f"{fmt(post[2])}\n")

    @staticmethod
    def _cal_likelihood(seq: str, qual: list[int], maj: str, min_: str
                        ) -> tuple[float, float, float]:
        """CalLikelihood (:2113-2155), float32 accumulation like C."""
        gl0 = gl1 = gl2 = np.float32(0)
        for b, q in zip(seq, qual):
            e = np.float32(rev_phred(float(q)))
            if b == maj:
                gl0 += np.float32(math.log10(1 - e))
                gl1 += np.float32(math.log10(0.5 - e / 3))
                gl2 += np.float32(math.log10(e / 3))
            elif b == min_:
                gl0 += np.float32(math.log10(e / 3))
                gl1 += np.float32(math.log10(0.5 - e / 3))
                gl2 += np.float32(math.log10(1 - e))
            else:
                v = np.float32(math.log10(2 * e / 3))
                gl0 += v
                gl1 += v
                gl2 += v
        return (float(math.floor(gl0 * -10 + 0.5)),
                float(math.floor(gl1 * -10 + 0.5)),
                float(math.floor(gl2 * -10 + 0.5)))

    def summary_output(self, prefix: str) -> None:
        import os

        with open(prefix + ".FASTQ.csv", "w") as fout:
            fout.write("FileIndex,PairEnd1,PairEnd2\n")
            for i, f in enumerate(self.fsc_vec):
                fout.write(f"{i + 1},{os.path.basename(f.file_name1)},"
                           f"{os.path.basename(f.file_name2)}\n")
        total_base = total_reads = total_retained = 0
        total_unmapped = total_low_mapq = 0
        with open(prefix + ".Sequence.csv", "w") as fout:
            fout.write("FileIndex,NumOfBases,NumOfReads,NumOfUmappedReads,"
                       "NumOfLowMAPQReads,NumOfQCPassReads,ReadLength\n")
            for i, f in enumerate(self.fsc_vec):
                rl = 0 if f.num_read == 0 else f.num_base // f.num_read
                fout.write(f"{i + 1},{f.num_base},{f.num_read},"
                           f"{f.bwa_unmapped},{f.total_mapq},"
                           f"{f.total_retained},{rl}\n")
                total_base += f.num_base
                total_reads += f.num_read
                total_retained += f.total_retained
                total_unmapped += f.bwa_unmapped
                total_low_mapq += f.total_mapq
            avg_read_len = math.floor(
                0.5 + (0 if total_reads == 0 else total_base / total_reads))
            fout.write(f"Total,{total_base},{total_reads},{total_unmapped},"
                       f"{total_low_mapq},{total_retained},{fmt(avg_read_len)}\n")

        with open(prefix + ".Summary", "w") as fout:
            fout.write("Statistics : Value\n")
            report_genome_size = (self.ref_genome_size - self.ref_N_size
                                  if len(self.target_region) == 0
                                  else self.target_region.total_size())
            est_mapped = (self.num_base_mapped / avg_read_len
                          * report_genome_size / self.total_region_size
                          if avg_read_len and self.total_region_size
                          else float("nan"))
            fout.write(f"Estimated Read Mapping Rate : "
                       f"{fmt(est_mapped / total_reads if total_reads else float('nan'))}\n")
            dup_rate = (self.num_pcr_dup / self.num_pair_reads
                        if self.num_pair_reads else float("nan"))
            fout.write(f"Estimated Read PCR Duplication Rate : {fmt(dup_rate)}"
                       f"[{self.num_pcr_dup}/{fmt(float(self.num_pair_reads))}]\n")
            fout.write(f"Whole Genome Coverage : "
                       f"{fmt(total_base / self.ref_genome_size if self.ref_genome_size else float('nan'))}"
                       f"[{total_base}/{self.ref_genome_size}]\n")
            fout.write(f"Expected Read Depth : "
                       f"{fmt(total_base / report_genome_size if report_genome_size else float('nan'))}"
                       f"[{total_base}/{report_genome_size}]\n")
            erd = (0 if self.num_pos_cov == 0
                   else self.num_base_mapped / self.total_region_size)
            fout.write(f"Estimated Read Depth : {fmt(erd)}"
                       f"[{self.num_base_mapped}/{self.total_region_size}]\n")
            fout.write(f"Reduced Genome Size : {self.total_region_size}\n")
            trs = self.total_region_size or 1
            fout.write(f"Depth 1 or above position fraction : "
                       f"{fmt(self.num_pos_cov / trs)}\n")
            fout.write(f"Depth 2 or above position fraction : "
                       f"{fmt(self.num_pos_cov2 / trs)}\n")
            fout.write(f"Depth 5 or above position fraction : "
                       f"{fmt(self.num_pos_cov5 / trs)}\n")
            fout.write(f"Depth 10 or above position fraction : "
                       f"{fmt(self.num_pos_cov10 / trs)}\n")
            q20 = int(self.sites.q20.sum())
            q30 = int(self.sites.q30.sum())
            fout.write(f"Q20 Base Fraction : "
                       f"{fmt(0 if self.num_base_mapped == 0 else q20 / self.num_base_mapped)}\n")
            fout.write(f"Q30 Base Fraction : "
                       f"{fmt(0 if self.num_base_mapped == 0 else q30 / self.num_base_mapped)}\n")
            npc = self.num_pos_cov or 1
            fout.write(f"Estimated AvgDepth for Q20 bases : {fmt(q20 / npc)}\n")
            fout.write(f"Estimated AvgDepth for Q30 bases : {fmt(q30 / npc)}\n")
            fout.write(f"Median Insert Size(>=500bp) : {self._mis(500)}\n")
            fout.write(f"Median Insert Size(>=300bp) : {self._mis(300)}\n")

    def _mis(self, lo: int) -> int:
        total = sum(self.insert_size_dist[lo:])
        tmp = 0
        for i in range(lo, len(self.insert_size_dist)):
            tmp += self.insert_size_dist[i]
            if tmp > total // 2:
                return i
        return 0
