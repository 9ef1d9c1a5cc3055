"""Marker pileup acquisition for contamination/ancestry estimation.

Equivalent of the reference's SimplePileupViewer
(VerifyBamID/SimplePileupViewer.cpp): either parse a textual pileup
(ReadPileup :767-845) or run an mpileup over the marker BED regions of a
sorted BAM (SIMPLEmpileup :277-600) with samtools-style read filters
(skip unmapped/secondary/qcfail/dup, min mapQ 13, min baseQ 2, pileup
symbols '.'/',' for ref matches).

Deviation from the reference noted for the BAM path: BAQ realignment
(MPLP_REALN) and overlapping-mate quality tweaking (MPLP_SMART_OVERLAPS)
are not applied; both only perturb base qualities of marginal reads.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..io.bam import BamReader

# BAM flags
BAM_FUNMAP = 4
BAM_FSECONDARY = 256
BAM_FQCFAIL = 512
BAM_FDUP = 1024

MIN_MQ = 13
MIN_BASEQ = 2


@dataclass
class PileupData:
    pos_index: dict[str, dict[int, int]] = field(default_factory=dict)
    base_info: list[list[str]] = field(default_factory=list)
    qual_info: list[list[int]] = field(default_factory=list)  # phred+33 ints
    num_bases: int = 0
    effective_num_site: int = 0
    avg_depth: float = 0.0
    sd_depth: float = 0.0
    seq_sm: str = "DefaultSampleName"
    is_pileup_input: bool = False

    def get_base(self, chrom: str, pos: int) -> list[str]:
        return self.base_info[self.pos_index[chrom][pos]]

    def get_qual(self, chrom: str, pos: int) -> list[int]:
        return self.qual_info[self.pos_index[chrom][pos]]

    def num_marker(self) -> int:
        return self.effective_num_site


def read_pileup_file(bed_table: dict[str, dict[int, tuple[str, str]]],
                     path: str) -> PileupData:
    """ReadPileup (:767-845): textual pileup restricted to bed markers.

    Improvement over the reference: FASTQuick's own .Pileup encodes bases
    as explicit letters (case = strand), but the likelihood model
    (getConditionalBaseLK) recognizes only '.'/',' as reference matches --
    the reference only sidesteps this because its shipped pipeline goes
    BAM -> mpileup.  We normalize: a base equal to the marker's ref
    allele becomes '.' (forward/uppercase) or ',' (reverse/lowercase),
    which is a no-op for samtools-style pileups (their ref matches are
    already './,' and letters are always mismatches).
    """
    d = PileupData(is_pileup_input=True)
    gi = 0
    with open(path) as fh:
        for line in fh:
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 6:
                continue
            chrom, pos_s, _ref, depth_s, seq, qual = cols[:6]
            pos = int(pos_s)
            if chrom not in bed_table or pos not in bed_table[chrom]:
                continue
            ref = bed_table[chrom][pos][0].upper()
            bases = [("." if b.isupper() else ",") if b.upper() == ref else b
                     for b in seq]
            ci = d.pos_index.setdefault(chrom, {})
            if pos in ci:
                idx = ci[pos]
                d.base_info[idx].extend(bases)
                d.qual_info[idx].extend(ord(c) for c in qual)
            else:
                ci[pos] = gi
                gi += 1
                d.base_info.append(bases)
                d.qual_info.append([ord(c) for c in qual])
            d.num_bases += int(depth_s)
            d.effective_num_site += 1
    if d.num_marker():
        d.avg_depth = d.num_bases / d.num_marker()
    return d


_NT4 = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _NT4[_c] = _i
    _NT4[_c | 0x20] = _i


def pileup_from_bam(bed_vec: list[tuple[str, int, int]],
                    bed_table: dict[str, dict[int, tuple[str, str]]],
                    bam_path: str, ref_fetch,
                    ref_range_fetch=None, baq: bool = True) -> PileupData:
    """mpileup-lite over marker positions of a (sorted or unsorted) BAM.

    ref_fetch(chrom, pos) -> ref base (for '.'/',' symbols), or None.
    ref_range_fetch(chrom, start0, end0) -> ref string for BAQ windows.

    Mirrors the reference's pileup configuration (SimplePileupViewer.cpp
    :688 MPLP_REALN | MPLP_SMART_OVERLAPS): when a reference is
    available, every read gets extended-BAQ quality capping at read
    time (bam_md.c:212, flag=3), and overlapping proper-pair mates get
    the htslib quality tweak at push time.  Base qualities are read at
    serialization so tweaks from later-arriving mates apply.
    """
    from .baq import baq_realign, tweak_overlap_quality

    d = PileupData()
    wanted: dict[str, set[int]] = {}
    for chrom, beg, end in bed_vec:
        wanted.setdefault(chrom, set()).add(end)  # end is the 1-based pos
    wanted_sorted = {c: np.array(sorted(s), dtype=np.int64)
                     for c, s in wanted.items()}

    reader = BamReader(bam_path)
    # sample name from @RG SM:
    for line in reader.header_text.splitlines():
        if line.startswith("@RG") and "SM:" in line:
            d.seq_sm = line.split("SM:")[1].split("\t")[0]
            break
    gi = 0
    # acc holds (record, query_index) refs; quals are resolved after all
    # overlap tweaks have run
    acc: dict[tuple[str, int], list[tuple[dict, int, str]]] = {}
    overlaps: dict[tuple[str, str], dict] = {}
    do_baq = baq and ref_range_fetch is not None
    for rec in reader:
        flag = rec["flag"]
        if flag & (BAM_FUNMAP | BAM_FSECONDARY | BAM_FQCFAIL | BAM_FDUP):
            continue
        if rec["mapq"] < MIN_MQ:
            continue
        if rec["refid"] < 0:
            continue
        chrom = reader.refs[rec["refid"]][0]
        if chrom.lower().startswith("chr"):
            chrom = chrom[3:]
        if chrom not in wanted:
            continue
        pos = rec["pos"]  # 0-based
        cigar = rec["cigar"] or [("M", len(rec["seq"]))]
        # BED-overlap read filter (SimplePileupViewer.cpp:226-227): a
        # read covering no marker is never pushed -- so it neither
        # contributes bases nor overlap-tweaks its mate
        ref_span = sum(ln for op, ln in cigar if op in ("M", "=", "X",
                                                        "D", "N"))
        ws = wanted_sorted[chrom]
        j = int(np.searchsorted(ws, pos + 1))
        if j >= len(ws) or ws[j] > pos + ref_span:
            continue
        qarr = np.frombuffer(rec["qual"], dtype=np.uint8).astype(np.int64)
        rec["qarr"] = qarr
        rec["cigar"] = cigar
        if do_baq and len(qarr):
            codes = _NT4[np.frombuffer(rec["seq"].encode("ascii"),
                                       dtype=np.uint8)]

            def fetch_codes(s0, e0, _c=chrom):
                s = ref_range_fetch(_c, s0, e0)
                out = _NT4[np.frombuffer(s.encode("ascii"), dtype=np.uint8)]
                return out

            nq = baq_realign(pos, cigar, codes, qarr, fetch_codes)
            if nq is not None:
                rec["qarr"] = qarr = np.asarray(nq, dtype=np.int64)
        # overlap tracking (htslib overlap_push gates: proper pair, mate
        # mapped, |isize| < 2*l_qseq)
        if (flag & 2) and not (flag & 8) and rec["seq"] \
                and abs(rec["tlen"]) < 2 * len(rec["seq"]):
            okey = (chrom, rec["qname"])
            first = overlaps.pop(okey, None)
            if first is not None:
                tweak_overlap_quality(first, rec)
            else:
                overlaps[okey] = rec
        qpos = 0
        rpos = pos
        reverse = bool(flag & 16)
        for op, ln in cigar:
            if op in ("M", "=", "X"):
                for k in range(ln):
                    p1 = rpos + k + 1  # 1-based
                    if p1 in wanted[chrom]:
                        base = rec["seq"][qpos + k]
                        ref = ref_fetch(chrom, p1) if ref_fetch else None
                        if ref is not None and base.upper() == ref.upper():
                            sym = "," if reverse else "."
                        else:
                            sym = base.lower() if reverse else base.upper()
                        acc.setdefault((chrom, p1), []).append(
                            (rec, qpos + k, sym))
                qpos += ln
                rpos += ln
            elif op in ("I", "S"):
                qpos += ln
            elif op in ("D", "N"):
                rpos += ln
            elif op == "H":
                pass
    # serialize in bed order; the base-quality floor applies to the
    # post-BAQ, post-tweak quality (as in the reference's emit filter)
    for chrom, beg, end in bed_vec:
        key = (chrom, end)
        if key not in acc:
            continue
        bases: list[str] = []
        quals: list[int] = []
        for rec, qi, sym in acc[key]:
            q = int(rec["qarr"][qi]) if qi < len(rec["qarr"]) else 0
            if q < MIN_BASEQ:
                continue
            bases.append(sym)
            quals.append(min(q + 33, 126))
        if not bases:
            continue
        ci = d.pos_index.setdefault(chrom, {})
        if end in ci:
            continue
        ci[end] = gi
        gi += 1
        d.base_info.append(bases)
        d.qual_info.append(quals)
        d.num_bases += len(bases)
        d.effective_num_site += 1
    if d.num_marker():
        d.avg_depth = d.num_bases / d.num_marker()
    return d
