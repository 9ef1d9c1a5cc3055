"""SAM/BAM record construction for aligned read pairs.

Equivalent of BwtMapper::SetSamRecord / SetSamFileHeader (reference
src/BwtMapper.cpp:999-1270) and bwa_print_sam1 (libbwa/bwase.c:455-):
reduced-reference coordinates are converted to real-genome coordinates by
parsing the contig name ``chr:pos@ref/alt[|L]``, and the output carries
the bwa tag set (XT/NM/XN/SM/AM/X0/X1/XM/XO/XG/MD/XA).
"""

from __future__ import annotations

import numpy as np

from ..index.builder import ReducedIndex
from ..io.bam import BamWriter, tag_A, tag_i, tag_Z
from .opts import (
    BWA_MODE_COMPREAD,
    BWA_TYPE_MATESW,
    BWA_TYPE_NO_MATCH,
    SAM_FMR,
    SAM_FMU,
    SAM_FSR,
    SAM_FSU,
    GapOpt,
)
from .refine import cigar_string, pos_end, pos_end_multi


def _real_coord(idx: ReducedIndex, pac_pos: int, opt: GapOpt
                ) -> tuple[str, int, int, str]:
    """(chrom, 1-based real position, seqid, contig_name)."""
    seqid, off = idx.coor_pac2real(pac_pos)
    c = idx.contigs[seqid]
    pos = pac_pos - c.offset + 1
    flank = opt.flank_long_len if c.is_long else opt.flank_len
    return c.chrom, c.pos - flank + pos - 1, seqid, c.name


_FWD_MAP = np.frombuffer(b"ACGTN", dtype=np.uint8)
_RC_MAP = np.frombuffer(b"TGCAN", dtype=np.uint8)


def _seq_qual(p) -> tuple[str, str]:
    """Sequence/quality in output orientation (SetSamRecord
    :1129-1150).  p.seq is forward after refine; reverse-strand output
    is the reverse complement."""
    if p.strand == 0:
        seq = _FWD_MAP[p.seq[: p.full_len]].tobytes().decode("ascii")
        qual = (p.qual[: p.full_len].tobytes().decode("latin1")
                if p.qual is not None else "*")
    else:
        seq = _RC_MAP[p.seq[: p.full_len][::-1]].tobytes().decode("ascii")
        qual = (p.qual[: p.full_len][::-1].tobytes().decode("latin1")
                if p.qual is not None else "*")
    return seq, qual


def _seq_qual_codes(p) -> tuple[np.ndarray, np.ndarray | None]:
    """Array form of _seq_qual for the BAM writer (skips the ASCII
    round-trip): encoded 0..4 codes in output orientation + phred+33."""
    if p.strand == 0:
        seq = p.seq[: p.full_len]
        qual = p.qual[: p.full_len] if p.qual is not None else None
    else:
        c = p.seq[: p.full_len][::-1]
        seq = np.where(c < 4, 3 - c, c).astype(np.uint8)
        qual = p.qual[: p.full_len][::-1] if p.qual is not None else None
    return seq, qual


def _pos5(p) -> int:
    if p.type != BWA_TYPE_NO_MATCH:
        return pos_end(p) if p.strand else p.pos
    return -1


class SamWriter:
    """Record construction + output.

    Writing runs on one worker thread (FIFO, so record order is
    preserved): the main alignment loop only enqueues (p, mate) pairs,
    while record packing and BGZF deflate happen concurrently -- the
    async analog of the reference letting SAM/BAM IO ride its output
    path while worker threads align the next batch."""

    _QUEUE_MAX = 0x40000

    def __init__(self, prefix: str, contig_sizes: list[tuple[str, int]],
                 rg_line: str, bam: bool = True):
        self.rg_line = rg_line.replace("\\t", "\t")
        self.rg_id = None
        if "\tID:" in self.rg_line:
            self.rg_id = self.rg_line.split("\tID:")[1].split("\t")[0].split("\n")[0]
        self.bam = bam
        header_lines = []
        for chrom, ln in contig_sizes:
            header_lines.append(f"@SQ\tSN:{chrom}\tLN:{ln}")
        if self.rg_line.startswith("@RG"):
            header_lines.append(self.rg_line)
        header_lines.append("@PG\tID:FASTQuick\tVN:1.0.0-tpu")
        header_text = "\n".join(header_lines) + "\n"
        if bam:
            self._bam = BamWriter(prefix + ".bam", header_text, contig_sizes)
            self._sam = None
        else:
            self._bam = None
            self._sam = open(prefix + ".sam", "w")
            self._sam.write(header_text)
        import queue
        import threading

        self._q: queue.Queue = queue.Queue(
            maxsize=max(1, self._QUEUE_MAX // self._CHUNK))
        self._err: BaseException | None = None
        self._pend: list[tuple] = []
        self.busy_s = 0.0  # writer-thread busy time (untimed by phases)
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._worker.start()

    def _drain(self) -> None:
        import time

        while True:
            chunk = self._q.get()
            if chunk is None:
                return
            t0 = time.perf_counter()
            try:
                if self._err is None:
                    if self._bam is not None:
                        self._write_chunk_bam(chunk)
                    else:
                        for idx, p, q, opt in chunk:
                            self._write_one(idx, p, q, opt)
                            if q is not None:
                                self._write_one(idx, q, p, opt)
            except BaseException as e:  # surfaced by close()
                self._err = e
            finally:
                self.busy_s += time.perf_counter() - t0
                self._q.task_done()

    # pairs per writer-queue item: record packing batches at this grain
    # (the per-record packing cost is what the batch amortizes)
    _CHUNK = 4096

    def write_pair(self, idx: ReducedIndex, p, q, opt: GapOpt) -> None:
        if self._err is not None:
            raise self._err
        self._pend.append((idx, p, q, opt))
        if len(self._pend) >= self._CHUNK:
            self._q.put(self._pend)
            self._pend = []

    def _write_chunk_bam(self, chunk: list[tuple]) -> None:
        """Pack a chunk's records in order and hand them to the batched
        BamWriter.write_records (one numpy pass per read length)."""
        recs = []
        for idx, p, q, opt in chunk:
            ends = ((p, q), (q, p)) if q is not None else ((p, None),)
            for a, b in ends:
                fields = self._record(idx, a, b, opt, txt=False)
                if fields is None:
                    continue
                (qname, flag, rname, pos, mapq, _cig_txt, rnext, pnext,
                 tlen, seq, qual, _tags_text, tags_bin) = fields
                cig = (a.cigar if (a.type != BWA_TYPE_NO_MATCH and a.cigar)
                       else (None if a.type == BWA_TYPE_NO_MATCH
                             else [(0, a.len)]))
                recs.append((qname, flag, rname, pos, mapq, cig, rnext,
                             pnext, tlen, seq, qual, tags_bin))
        self._bam.write_records(recs)

    def _write_one(self, idx: ReducedIndex, p, mate, opt: GapOpt) -> None:
        fields = self._record(idx, p, mate, opt, txt=self._sam is not None)
        if fields is None:
            return
        if self._sam is not None:
            (qname, flag, rname, pos, mapq, cigar, rnext, pnext, tlen, seq,
             qual, tags_text, _tags_bin) = fields
            cols = [qname, str(flag), rname, str(pos), str(mapq), cigar,
                    rnext, str(pnext), str(tlen), seq, qual] + tags_text
            self._sam.write("\t".join(cols) + "\n")
        else:
            (qname, flag, rname, pos, mapq, cigar, rnext, pnext, tlen, seq,
             qual, _tags_text, tags_bin) = fields
            cig = p.cigar if (p.type != BWA_TYPE_NO_MATCH and p.cigar) else (
                None if p.type == BWA_TYPE_NO_MATCH else [(0, p.len)])
            self._bam.write_record(qname, flag, rname, pos, mapq, cig, rnext,
                                   pnext, tlen, seq, qual, tags_bin)

    def _record(self, idx: ReducedIndex, p, mate, opt: GapOpt,
                txt: bool = True):
        tags_text: list[str] = []
        tags_bin = b""
        if self.rg_id:
            if txt:
                tags_text.append(f"RG:Z:{self.rg_id}")
            else:
                tags_bin += tag_Z("RG", self.rg_id)

        if p.type != BWA_TYPE_NO_MATCH or (mate is not None
                                           and mate.type != BWA_TYPE_NO_MATCH):
            flag = p.extra_flag
            if p.type == BWA_TYPE_NO_MATCH:
                p.pos = mate.pos
                p.strand = mate.strand
                flag |= SAM_FSU
                j = 1
            else:
                j = pos_end(p) - p.pos
            chrom, real_pos, seqid, _ = _real_coord(idx, p.pos, opt)
            if (p.type != BWA_TYPE_NO_MATCH
                    and p.pos + j - idx.contigs[seqid].offset
                    > idx.contigs[seqid].length):
                flag |= SAM_FSU
            if p.strand:
                flag |= SAM_FSR
            if mate is not None:
                if mate.type != BWA_TYPE_NO_MATCH:
                    if mate.strand:
                        flag |= SAM_FMR
                else:
                    flag |= SAM_FMU
            if p.type == BWA_TYPE_NO_MATCH:
                rname, pos_out = "*", 0
            else:
                rname, pos_out = chrom, real_pos
            cigar = (("*" if p.type == BWA_TYPE_NO_MATCH
                      else cigar_string(p.cigar, p.len)) if txt else None)
            # mate coordinates
            rnext, pnext, tlen = "*", 0, 0
            if mate is not None and mate.type != BWA_TYPE_NO_MATCH:
                m_chrom, m_real, m_seqid, _ = _real_coord(idx, mate.pos, opt)
                rnext = "=" if seqid == m_seqid else m_chrom
                tlen = _pos5(mate) - _pos5(p) if seqid == m_seqid else 0
                if p.type == BWA_TYPE_NO_MATCH:
                    tlen = 0
                pnext = m_real
            elif mate is not None:
                rnext = "="
                pnext = real_pos if p.type != BWA_TYPE_NO_MATCH else 0
            seq, qual = _seq_qual(p) if txt else _seq_qual_codes(p)
            if p.type != BWA_TYPE_NO_MATCH:
                xt = "NURM"[p.type]
                if txt:
                    tags_text.append(f"XT:A:{xt}")
                else:
                    tags_bin += tag_A("XT", xt)
                nm_tag = "NM" if opt.mode & BWA_MODE_COMPREAD else "CM"
                if txt:
                    tags_text.append(f"{nm_tag}:i:{p.nm}")
                else:
                    tags_bin += tag_i(nm_tag, p.nm)
                if mate is not None:
                    am = min(mate.seQ, p.seQ)
                    if txt:
                        tags_text.append(f"SM:i:{p.seQ}")
                    else:
                        tags_bin += tag_i("SM", p.seQ)
                    if txt:
                        tags_text.append(f"AM:i:{am}")
                    else:
                        tags_bin += tag_i("AM", am)
                if p.type != BWA_TYPE_MATESW:
                    if txt:
                        tags_text.append(f"X0:i:{p.c1}")
                    else:
                        tags_bin += tag_i("X0", p.c1)
                    if p.c1 <= opt.max_top2:
                        if txt:
                            tags_text.append(f"X1:i:{p.c2}")
                        else:
                            tags_bin += tag_i("X1", p.c2)
                if txt:
                    tags_text.append(f"XM:i:{p.n_mm}")
                else:
                    tags_bin += tag_i("XM", p.n_mm)
                if txt:
                    tags_text.append(f"XO:i:{p.n_gapo}")
                else:
                    tags_bin += tag_i("XO", p.n_gapo)
                if txt:
                    tags_text.append(f"XG:i:{p.n_gapo + p.n_gape}")
                else:
                    tags_bin += tag_i("XG", p.n_gapo + p.n_gape)
                if p.md:
                    if txt:
                        tags_text.append(f"MD:Z:{p.md}")
                    else:
                        tags_bin += tag_Z("MD", p.md)
                if p.multi:
                    xa = []
                    for q in p.multi:
                        jl = pos_end_multi(q, p.len) - q.pos
                        m_chrom2, m_real2, _, _ = _real_coord(idx, q.pos, opt)
                        strand_c = "-" if q.strand else "+"
                        cg = cigar_string(q.cigar, p.len)
                        xa.append(f"{m_chrom2},{strand_c}{m_real2},{cg},"
                                  f"{q.gap + q.mm};")
                    if txt:
                        tags_text.append("XA:Z:" + "".join(xa))
                    else:
                        tags_bin += tag_Z("XA", "".join(xa))
            return (p.name, flag, rname, pos_out, p.mapQ, cigar, rnext, pnext,
                    tlen, seq, qual, tags_text, tags_bin)

        # unmapped (both)
        flag = p.extra_flag | SAM_FSU
        if mate is not None and mate.type == BWA_TYPE_NO_MATCH:
            flag |= SAM_FMU
        s = p.rseq if p.strand else p.seq
        if txt:
            seq = _FWD_MAP[np.asarray(s[: p.len])].tobytes().decode("ascii")
            qual = (np.asarray(p.qual[::-1] if p.strand else p.qual)
                    .tobytes().decode("ascii")
                    if p.qual is not None else "*")
        else:
            seq = np.asarray(s[: p.len])
            qual = (np.asarray(p.qual[::-1] if p.strand else p.qual)
                    if p.qual is not None else None)
        return (p.name, flag, "*", 0, 0, "*", "*", 0, 0, seq, qual,
                tags_text, tags_bin)

    def close(self) -> None:
        if self._pend:
            self._q.put(self._pend)
            self._pend = []
        self._q.put(None)
        self._worker.join()
        if self._bam is not None:
            self._bam.close()
        if self._sam is not None:
            self._sam.close()
        if self._err is not None:
            raise self._err
