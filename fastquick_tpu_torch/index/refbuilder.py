"""Marker selection and reduced-reference construction.

Equivalent of the reference's RefBuilder (src/RefBuilder.cpp):
- SelectMarker (:319-462): stream a candidate-site VCF once (twice with a
  target region), selecting num_variant_long long-flank + num_variant_short
  short-flank autosomal markers plus up to maxXorYmarker X and Y markers,
  with priority target-long > target-short > nontarget-long >
  nontarget-short (comment :312-318).
- Skip (:70-146): autosome/X/Y whitelist, biallelic single-base SNVs only,
  0.01 <= AF <= 0.99 (MIN_AF :16), no flank overlap with already-chosen
  markers, >= 99.5% callable (CALLABLE_RATE :17) under an optional
  BED/FASTA mask.
- InputPredefinedMarker (:464-574): load a predefined marker VCF, detecting
  the ##FASTQuickVersion header (:473-480).
- PrepareRefSeq/SubstrRef (:576-635): write contigs named
  ``>chr:pos@ref/alt[|L]`` with the ref allele substituted at the center,
  plus per-position 100bp-window GC counts into the binary .gc file.
- The bcftools shell-out for the dbSNP subset (:452-460) is replaced by a
  native streaming subset with the same region semantics.

Marker output order follows C++ std::map iteration: chromosomes in
lexicographic string order, positions ascending.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import PACKAGE_VERSION
from ..io.fasta import FastaFile
from ..io.gc import write_gc_records
from ..io.region import RegionList
from ..io.vcf import VcfReader, VcfRecord, normalize_chrom
from ..utils.logging import error, notice, warning

MIN_AF = 0.01
CALLABLE_RATE = 0.995

CHROM_WHITELIST = {str(i) for i in range(1, 23)} | {"X", "Y"}

# chrFlag values (reference comment /*0:short;1:long;2:Y;3:X*/)
FLAG_SHORT, FLAG_LONG, FLAG_Y, FLAG_X = 0, 1, 2, 3


@dataclass
class Marker:
    chrom: str  # normalized (no 'chr', uppercase)
    pos: int  # 1-based
    rec: VcfRecord
    flank_len: int

    @property
    def is_long(self) -> bool:
        return "L" in self.rec.id  # reference: any 'L' in the ID string


@dataclass
class RefBuilder:
    vcf_path: str
    ref_path: str
    new_ref: str  # <prefix>.FASTQuick.fa
    dbsnp_path: str
    mask_path: str = "Empty"
    flank_short_len: int = 250
    flank_long_len: int = 1000
    num_variant_short: int = 9000
    num_variant_long: int = 1000

    n_short: int = 0
    n_long: int = 0
    n_x: int = 0
    n_y: int = 0
    # chrom -> {pos -> index into markers}
    vcf_table: dict[str, dict[int, int]] = field(default_factory=dict)
    markers: list[Marker] = field(default_factory=list)
    callable_regions: RegionList | None = None
    fasta_mask: FastaFile | None = None

    def __post_init__(self):
        if self.num_variant_short >= 100000:
            self.max_xy_marker = 3000
        elif self.num_variant_short >= 10000:
            self.max_xy_marker = 300
        else:
            self.max_xy_marker = 100
        if self.mask_path != "Empty":
            suffix = self.mask_path[-3:].lower()
            if suffix == "bed":
                self.callable_regions = RegionList().read_region_list(
                    self.mask_path, collapse=False)
                # reference stores a std::map keyed by start with max end
                # (src/RefBuilder.cpp:223-234): sort + dedup by start
                for chrom, ivs in self.callable_regions.regions.items():
                    by_start: dict[int, int] = {}
                    for s, e in ivs:
                        if by_start.get(s, -1) < e:
                            by_start[s] = e
                    self.callable_regions.regions[chrom] = sorted(
                        by_start.items())
                notice("Loading Mask Bed file done!")
            elif suffix in (".fa", "sta", ".gz"):
                self.fasta_mask = FastaFile(self.mask_path)
                notice("Loading Mask fai file done!")
            else:
                warning("Unknown file type for %s, fasta or bed file is required",
                        self.mask_path)

    # ---- selection gates ----

    def _flank_of_index(self, idx: int) -> int:
        # GetFlankLen: long iff ID ends with 'L' (reference :61-68 checks
        # back() == 'L')
        return (self.flank_long_len
                if self.markers[idx].rec.id.endswith("L")
                else self.flank_short_len)

    def is_max_num_marker(self, chrom: str, forced_short: bool = False,
                          forced_long: bool = False) -> tuple[bool, int]:
        """Returns (at_quota, chrFlag). Mirrors IsMaxNumMarker (:257-291)."""
        if chrom == "X":
            if self.n_x >= self.max_xy_marker:
                return True, -1
            return False, FLAG_X
        if chrom == "Y":
            if self.n_y >= self.max_xy_marker:
                return True, -1
            return False, FLAG_Y
        # autosome
        if (self.n_long >= self.num_variant_long
                and self.n_short >= self.num_variant_short):
            return True, -1
        if forced_long:
            return False, FLAG_LONG
        if forced_short:
            return False, FLAG_SHORT
        if self.n_long < self.num_variant_long:
            return False, FLAG_LONG
        return False, FLAG_SHORT

    def increase_num_marker(self, chr_flag: int) -> None:
        if chr_flag == FLAG_SHORT:
            self.n_short += 1
        elif chr_flag == FLAG_LONG:
            self.n_long += 1
        elif chr_flag == FLAG_Y:
            self.n_y += 1
        elif chr_flag == FLAG_X:
            self.n_x += 1
        else:
            error("Unexpected chromosome flag!")

    def skip(self, chrom: str, pos: int, rec: VcfRecord, chr_flag: int) -> bool:
        """Skip() gates (reference :70-146). True means reject."""
        if chrom not in CHROM_WHITELIST:
            return True
        if len(rec.ref) != 1 or len(rec.alt) != 1 or "," in rec.alt:
            return True
        af = rec.get_af()
        if af is None:
            warning("%s:%d has no AF tag in INFO field", chrom, pos)
            return True
        if af < MIN_AF or af > 1 - MIN_AF:
            return True

        flank_len = (self.flank_long_len if chr_flag == FLAG_LONG
                     else self.flank_short_len)

        # no overlap with previously selected markers
        tbl = self.vcf_table.get(chrom)
        if tbl:
            positions = sorted(tbl)  # std::map ordering
            import bisect

            i = bisect.bisect_right(positions, pos)
            if i > 0:
                left = positions[i - 1]
                if abs(pos - left) < self._flank_of_index(tbl[left]) + flank_len:
                    return True
                if i < len(positions):
                    right = positions[i]
                    if abs(pos - right) < self._flank_of_index(tbl[right]) + flank_len:
                        return True
            else:
                first = positions[0]
                # reference quirk (:115-119): compares abs(pos - adj + 1)
                if abs(pos - first + 1) < self._flank_of_index(tbl[first]) + flank_len:
                    return True

        # callable-region mask
        if self.mask_path != "Empty":
            if self.callable_regions is not None:
                if not self._is_callable(chrom, pos - flank_len, pos + flank_len):
                    return True
            elif self.fasta_mask is not None:
                seq = self.fasta_mask.fetch(chrom, pos - flank_len, pos + flank_len)
                if seq is None:
                    seq = self.fasta_mask.fetch("chr" + chrom, pos - flank_len,
                                                pos + flank_len)
                if seq is None:
                    error("Cannot find %s:%d in mask fasta", chrom, pos)
                n_callable = seq.count("P")
                if n_callable < CALLABLE_RATE * len(seq):
                    return True
        return False

    def _is_callable(self, chrom: str, start: int, end: int) -> bool:
        """IsInCallableRegion (:161-188): >=99.5% of [start,end] covered."""
        rl = self.callable_regions
        if chrom not in rl.regions:
            return False
        length = end - start + 1
        overlap = 0
        for s, e in rl.regions[chrom]:
            if s > end:
                break
            lo, hi = max(s, start), min(e, end)
            if lo <= hi:
                # reference OverlapLen (:152-159): abs(min(c,d)-max(a,b))
                overlap += abs(hi - lo)
        return length * CALLABLE_RATE <= overlap

    def _accept(self, chrom: str, pos: int, rec: VcfRecord, chr_flag: int) -> None:
        idx = self.n_short + self.n_long + self.n_x + self.n_y
        self.vcf_table.setdefault(chrom, {})[pos] = idx
        flank = (self.flank_long_len if "L" in rec.id else self.flank_short_len)
        self.markers.append(Marker(chrom, pos, rec, flank))
        self.increase_num_marker(chr_flag)

    # ---- selection drivers ----

    def select_marker(self, region_path: str = "Empty") -> None:
        notice("Start to select markers...")
        n_target = 0
        n_nontarget = 0
        meta_lines: list[str] = []
        header_line = ""
        if region_path != "Empty":
            notice("Start to select markers from target regions...")
            target = RegionList().read_region_list(region_path, collapse=True)
            with VcfReader(self.vcf_path) as reader:
                meta_lines = list(reader.meta_lines)
                header_line = reader.header_line
                for rec in reader:
                    chrom = normalize_chrom(rec.chrom)
                    pos = rec.pos
                    forced_short = False
                    while True:  # RESCUE retry with forced short flank
                        at_max, chr_flag = self.is_max_num_marker(
                            chrom, forced_short=forced_short)
                        if at_max:
                            break
                        if not target.is_overlapped(chrom, pos):
                            break
                        if self.skip(chrom, pos, rec, chr_flag):
                            if not forced_short:
                                forced_short = True
                                continue
                            break
                        suffix = "$E|L" if chr_flag == FLAG_LONG else "$E"
                        rec.id = rec.id + suffix
                        self._accept(chrom, pos, rec, chr_flag)
                        n_target += 1
                        break
        with VcfReader(self.vcf_path) as reader:
            meta_lines = list(reader.meta_lines)
            header_line = reader.header_line
            for rec in reader:
                chrom = normalize_chrom(rec.chrom)
                pos = rec.pos
                at_max, chr_flag = self.is_max_num_marker(chrom)
                if at_max:
                    continue
                if self.skip(chrom, pos, rec, chr_flag):
                    continue
                if chr_flag == FLAG_LONG:
                    rec.id = rec.id + "|L"
                self._accept(chrom, pos, rec, chr_flag)
                n_nontarget += 1
        notice("Selected %d markers from target region, %d markers from "
               "non-target region.", n_target, n_nontarget)
        if self.n_short + self.n_long < self.num_variant_long + self.num_variant_short:
            warning("Insufficient candidate markers(%d/%d) in %s",
                    self.n_short + self.n_long,
                    self.num_variant_long + self.num_variant_short, self.vcf_path)
        meta_lines = meta_lines + [f"##FASTQuickVersion={PACKAGE_VERSION}"]
        self._write_selected(meta_lines, header_line)
        self._subset_dbsnp()

    def input_predefined_marker(self, predefined_vcf: str) -> None:
        notice("Start to load predefined marker set...")
        with VcfReader(predefined_vcf) as reader:
            meta_lines = list(reader.meta_lines)
            header_line = reader.header_line
            is_fastquick = any("##FASTQuickVersion" in m for m in meta_lines)
            if is_fastquick:
                notice("Detect FASTQuick format in predefined marker set")
            for rec in reader:
                chrom = normalize_chrom(rec.chrom)
                pos = rec.pos
                at_max, chr_flag = self.is_max_num_marker(chrom)
                if not is_fastquick:
                    if at_max:
                        continue
                    if self.skip(chrom, pos, rec, chr_flag):
                        warning("%s:%d is a low quality marker. Consider "
                                "filtering it.", rec.chrom, rec.pos)
                    if chr_flag == FLAG_LONG:
                        rec.id = rec.id + "|L"
                else:
                    if at_max:
                        error("Unexpectedly reach maximal number of markers "
                              "in FASTQuick format!")
                self._accept(chrom, pos, rec, chr_flag)
        if self.n_short + self.n_long < self.num_variant_long + self.num_variant_short:
            warning("Insufficient candidate markers %d/%d in %s.",
                    self.n_short + self.n_long,
                    self.num_variant_long + self.num_variant_short, predefined_vcf)
        else:
            notice("%s contains sufficient markers.", predefined_vcf)
        self._write_selected(meta_lines, header_line)
        self._subset_dbsnp()

    # ---- outputs ----

    def ordered_markers(self) -> list[Marker]:
        """Markers in output order: chrom lexicographic, pos ascending."""
        out: list[Marker] = []
        for chrom in sorted(self.vcf_table):
            for pos in sorted(self.vcf_table[chrom]):
                out.append(self.markers[self.vcf_table[chrom][pos]])
        return out

    def _write_selected(self, meta_lines: list[str], header_line: str) -> None:
        sel_path = self.new_ref + ".SelectedSite.vcf"
        bed_path = self.new_ref + ".bed"
        with open(sel_path, "w") as vout, open(bed_path, "w") as bout:
            for m in meta_lines:
                vout.write(m + "\n")
            if header_line:
                vout.write(header_line + "\n")
            for mk in self.ordered_markers():
                vout.write(mk.rec.to_line() + "\n")
                flank = (self.flank_long_len if mk.rec.id.endswith("L")
                         else self.flank_short_len)
                bout.write(f"{mk.chrom}\t{mk.pos - flank}\t{mk.pos + flank}\n")

    def _subset_dbsnp(self) -> None:
        """Native replacement for the bcftools -R shell-out (:452-460):
        keep dbSNP SNV records overlapping any marker flank region."""
        regions = RegionList()
        for mk in self.ordered_markers():
            flank = (self.flank_long_len if mk.rec.id.endswith("L")
                     else self.flank_short_len)
            # bed (pos-flank, pos+flank) is interpreted by bcftools as
            # 1-based [start+1, end]; RegionList is closed [s, e], so
            # shift the start by one
            regions.add(mk.chrom, mk.pos - flank + 1, mk.pos + flank)
        regions.collapse()
        out_path = self.new_ref + ".dbSNP.subset.vcf"
        n_kept = 0
        with VcfReader(self.dbsnp_path) as reader, open(out_path, "w") as out:
            for m in reader.meta_lines:
                out.write(m + "\n")
            if reader.header_line:
                out.write(reader.header_line + "\n")
            for rec in reader:
                if len(rec.ref) != 1:
                    continue
                if not any(len(a) == 1 and a in "ACGTacgt" for a in rec.alts):
                    continue
                chrom = normalize_chrom(rec.chrom)
                if regions.is_overlapped(chrom, rec.pos):
                    out.write(rec.to_line() + "\n")
                    n_kept += 1
        notice("dbSNP subset: kept %d records", n_kept)

    def prepare_ref_seq(self) -> None:
        """PrepareRefSeq (:616-635): write the reduced-reference FASTA and
        the binary .gc file in marker order."""
        fa = FastaFile(self.ref_path)
        notice("Loading Ref fai file done!")
        gc_records: list[np.ndarray] = []
        with open(self.new_ref, "w") as fout:
            for mk in self.ordered_markers():
                rec = mk.rec
                is_long = "L" in rec.id
                flank = self.flank_long_len if is_long else self.flank_short_len
                name = f"{rec.chrom}:{rec.pos}@{rec.ref}/{rec.alt}"
                if is_long:
                    name += "|L"
                fetched = fa.fetch(rec.chrom, rec.pos - flank, rec.pos + flank)
                if fetched is None:
                    fetched = fa.fetch("chr" + rec.chrom, rec.pos - flank,
                                       rec.pos + flank)
                if fetched is None:
                    error("Cannot find %s:%d-%d from the reference file!",
                          rec.chrom, rec.pos - flank, rec.pos + flank)
                contig = fetched[:flank] + rec.ref + fetched[flank + 1: 2 * flank + 1]
                fout.write(f">{name}\n{contig}\n")
                gc_records.append(self._calc_gc(fa, rec.chrom, rec.pos, flank))
        write_gc_records(self.new_ref + ".gc", gc_records)
        fa.close()

    @staticmethod
    def _calc_gc(fa: FastaFile, chrom: str, pos: int, flank: int) -> np.ndarray:
        """CalculateGC (:38-54): GC count in the 100bp window (i-50, i+49)
        for each i in [pos-flank, pos+flank]."""
        lo = pos - flank - 50
        hi = pos + flank + 49
        window = fa.fetch(chrom, lo, hi)
        if window is None:
            window = fa.fetch("chr" + chrom, lo, hi)
        if window is None:
            error("Cannot find %s:%d-%d from the reference file!", chrom, lo, hi)
        # offset of base `lo_clamped` in window: fetch clamps at 1
        clamp_shift = max(0, 1 - lo)
        arr = np.frombuffer(window.encode("ascii"), dtype=np.uint8)
        is_gc = ((arr == ord("G")) | (arr == ord("C"))
                 | (arr == ord("g")) | (arr == ord("c"))).astype(np.int32)
        cs = np.concatenate([[0], np.cumsum(is_gc)])
        # window for position i is [i-50, i+49] clamped;
        # arr[0] corresponds to genome position lo + clamp_shift
        i = np.arange(pos - flank, pos + flank + 1, dtype=np.int64)
        a = np.clip((i - 50) - (lo + clamp_shift), 0, len(arr))
        b = np.clip((i + 49) - (lo + clamp_shift) + 1, 0, len(arr))
        return np.where(b > a, cs[b] - cs[a], 0).astype(np.uint8)
