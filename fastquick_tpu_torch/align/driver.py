"""Align-stage driver: fastquick align.

Equivalent of runAlign (reference src/FASTQuick.cpp:159-491) +
BwtMapper ctor (src/BwtMapper.cpp:177-291) + PairEndMapper /
SingleEndMapper batch loops (single-thread reference order, which is the
deterministic behavior; the reference's thread pool only changes
scheduling).  Batches stream through:

  read+filter -> engine.align_batch (K1/K2) -> aln2seq + positions ->
  isize -> pairing -> mate-rescue SW (K3) -> gapped refine + MD ->
  StatCollector (K4) + SAM/BAM out

then StatCollector.process_core writes the 14 QC files.

In device-QC mode (``--device_qc``, the default engine on a CUDA device)
the k-mer filter, the search (ops/batch_search.BatchEngine), the
mate-rescue SW forward passes and the dense statistics run on the torch
device chosen by ``--device`` (cuda, the default, or cpu for the plain
PyTorch versions); asking for cuda without a CUDA device raises.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..index.builder import ReducedIndex, load_index
from ..params import ParamList
from ..stats.collector import FileStat, StatCollector
from ..utils.logging import error, notice, realtime
from ..utils.spans import call, span
from .core import bwa_aln2seq_core, bwa_approx_mapQ
from .device_qc import flush_batch
from .engine import HostEngine, NativeEngine
from .opts import (
    BWA_MODE_GAPE,
    BWA_MODE_IL13,
    BWA_MODE_LOGGAP,
    BWA_MODE_NONSTOP,
    BWA_TYPE_MATESW,
    BWA_TYPE_NO_MATCH,
    BWA_TYPE_REPEAT,
    BWA_TYPE_UNIQUE,
    SAM_FMU,
    SAM_FPD,
    SAM_FPP,
    SAM_FR1,
    SAM_FR2,
    GapOpt,
    PeOpt,
    bwa_cal_maxdiff,
)
from .pe import (
    MIN_HASH_WIDTH,
    IsizeInfo,
    bwa_paired_sw,
    infer_isize,
    pairing,
    sa_pos,
)
from .rand import Rand48
from .refine import (
    bwa_cal_md1_batch,
    bwa_correct_trimmed,
    pos_end,
    refine_gapped_core,
)
from .sample_setup import (
    exact_engine,
    index_options,
    load_contig_sizes,
    sample_collector,
)
from .seqs import FastqReader, Read, read_batch
from .sam import SamWriter

READ_BUFFER_SIZE = 0x40000


class _SamWriter(SamWriter):
    """SamWriter (align/sam.py, a copy of the reference package's module)
    with each BAM chunk's record packing and deflate timed as the span
    `bam.write`, on the writer thread."""

    def _write_chunk_bam(self, chunk: list[tuple]) -> None:
        with span("bam.write"):
            super()._write_chunk_bam(chunk)

# what the last run_align did (engine, device search totals, and under
# "stage_t" the seconds of every span of the call, utils/spans.py): read by
# chip_smoke.py, portbench and the tests
LAST_RUN_STATS: dict = {}


class PairEndMapper:
    def __init__(self, idx: ReducedIndex, engine, opt: GapOpt, popt: PeOpt,
                 collector: StatCollector, sam: SamWriter, isize_out,
                 device_filter: bool = False,
                 device: torch.device | None = None,
                 device_sw: bool = False):
        self.idx = idx
        self.device = device if device is not None else torch.device("cpu")
        self.device_sw = device_sw  # mate rescue on `device` (device QC)
        self.engine = engine
        self.opt = opt
        self.popt = popt
        self.collector = collector
        self.sam = sam
        self.isize_out = isize_out
        self.rng = Rand48(11)  # srand48(bns->seed), BwtMapper.cpp:1427
        self.g_hash: dict[int, list[int]] = {}  # SA-interval position cache
        self.device_filter = device_filter and idx.kmer.thresh != 0
        self._dev_bitmaps = None
        self.batches = 0  # read batches aligned by run()

    def _open_reader(self, path: str):
        """Native C++ loader fast path (parse+trim+filter); Python
        fallback (also used when downsampling needs the seeded RNG).
        With --device_filter, the k-mer gate moves to the accelerator
        (ops/kmer.filter_reads over device-resident bitmaps), so the reader
        runs unfiltered."""
        opt = self.opt
        kmer = None if self.device_filter else self.idx.kmer
        thresh = 0 if self.device_filter else self.idx.kmer.thresh
        if opt.frac >= 1.0:
            try:
                from .seqs import NativeFastqReader

                return NativeFastqReader(path, kmer, opt.trim_qual,
                                         thresh), True
            except Exception:
                pass
        return FastqReader(path), False

    def _apply_device_filter(self, batch: list[Read]) -> None:
        """Run the 6-projection k-mer gate on device for a whole batch
        (result-identical to the host filter -- tests/test_ops_kmer) and
        restore the reader's filtered-read layout (forward codes)."""
        if not batch:
            return
        from ..ops.kmer import filter_reads, load_kmer_bitmaps

        if self._dev_bitmaps is None:
            # uploaded once: 6 x 512 MiB, copied table by table
            with span("kmer.upload"):
                self._dev_bitmaps = load_kmer_bitmaps(
                    self.idx.kmer.byte_bitmaps(), self.device)
        with span("kmer.filter"):
            L = max(p.len for p in batch)
            seqs = np.zeros((len(batch), L), dtype=np.uint8)
            lens = np.zeros(len(batch), dtype=np.int32)
            for i, p in enumerate(batch):
                seqs[i, :p.len] = p.seq[:p.len][::-1]  # back to forward codes
                lens[i] = p.len
            keep = filter_reads(self._dev_bitmaps,
                                torch.from_numpy(seqs).to(self.device),
                                torch.from_numpy(lens).to(self.device),
                                thresh=self.idx.kmer.thresh).cpu().numpy()
            for i, p in enumerate(batch):
                if not keep[i]:
                    p.filtered = True
                    # reader layout for filtered reads: full forward codes
                    p.seq = np.concatenate([p.seq[:p.len][::-1],
                                            p.seq[p.len:]])
                    p.rseq = None

    def _next_batch(self, reader, native: bool, batch_size: int,
                    round_no: int) -> list[Read]:
        opt = self.opt
        from .opts import BWA_MODE_COMPREAD

        with span("io.read"):
            if native:
                batch = reader.read_batch(batch_size,
                                          bool(opt.mode & BWA_MODE_COMPREAD))
            else:
                batch = read_batch(reader, None if self.device_filter
                                   else self.idx.kmer, batch_size, opt.mode,
                                   opt.trim_qual, opt.frac, round_no)
        if self.device_filter:
            self._apply_device_filter(batch)
        return batch

    def run(self, fq1: str, fq2: str, fsc: FileStat,
            batch_size: int = READ_BUFFER_SIZE) -> None:
        """Double-buffered IO (the reference's IOworkerAlt pipeline,
        src/BwtMapper.cpp:709-718, :2095-2104): a prefetch thread parses
        + filters the NEXT pair of batches (the native loader releases
        the GIL) while the main thread aligns the current one."""
        import threading

        opt = self.opt
        r1, nat1 = self._open_reader(fq1)
        r2, nat2 = self._open_reader(fq2)
        last_ii = IsizeInfo()

        # the native loader releases the GIL, so the two files decode +
        # k-mer-filter concurrently; the Python fallback stays sequential
        # (its per-round downsampling RNG must see reads in order)
        par_io = nat1 and nat2 and not self.device_filter

        def fetch(round_no):
            with span("io+filter"):
                if par_io:
                    res = [None, None]

                    def rd(k, rdr, nat):
                        res[k] = self._next_batch(rdr, nat, batch_size,
                                                  round_no)

                    th2 = threading.Thread(target=rd, args=(1, r2, nat2))
                    th2.start()
                    rd(0, r1, nat1)
                    th2.join()
                    b0, b1 = res
                else:
                    b0 = self._next_batch(r1, nat1, batch_size, round_no)
                    b1 = self._next_batch(r2, nat2, batch_size, round_no)
            return b0, b1

        nxt: list = [None]

        def prefetch(round_no):
            nxt[0] = fetch(round_no)

        # stats worker (the reference's PEworker analog,
        # src/BwtMapper.cpp:654-684): one FIFO thread applies the
        # stats+output stage of batch k while the main thread aligns
        # batch k+1.  A single worker preserves accumulation order
        # (pileup strings, dup table, .InsertSizeTable rows).
        import queue

        statq: queue.Queue = queue.Queue(maxsize=2)
        stats_err: list = []

        def stats_worker():
            while True:
                item = statq.get()
                if item is None:
                    return
                try:
                    if not stats_err:
                        self._stats_out(*item)
                except BaseException as e:
                    stats_err.append(e)
                finally:
                    statq.task_done()

        sworker = threading.Thread(target=stats_worker)
        sworker.start()

        cur = fetch(0)
        round_no = 1
        try:
            while True:
                b0, b1 = cur
                if not b0 and not b1:
                    break
                self.batches += 1
                th = threading.Thread(target=prefetch, args=(round_no,))
                th.start()
                round_no += 1
                if len(b0) != len(b1):
                    th.join()
                    error("Pair-end files out of sync: %d vs %d reads",
                          len(b0), len(b1))
                with span("search"):
                    self.engine.align_batch(b0, opt)
                    self.engine.align_batch(b1, opt)
                ii = self._process_batch(b0, b1, last_ii, fsc, statq)
                last_ii = ii
                with span("wait.prefetch"):
                    th.join()
                cur = nxt[0]
                if stats_err:
                    raise stats_err[0]
        finally:
            with span("wait.stats"):
                statq.put(None)
                sworker.join()
        if stats_err:
            raise stats_err[0]
        r1.close()
        r2.close()

    def _process_batch(self, b0: list[Read], b1: list[Read],
                       last_ii: IsizeInfo, fsc: FileStat,
                       statq=None) -> IsizeInfo:
        with span("pe"):
            ii = self._pair(b0, b1, last_ii)

        # --- mate rescue SW ---
        with span("mate-sw"):
            bwa_paired_sw(self.idx.text, list(zip(b0, b1)), self.popt, ii,
                          self.opt.mode, self.device, self.device_sw)

        # --- gapped refinement + MD ---
        with span("refine"):
            for batch in (b0, b1):
                self._refine_gapped(batch)

        # --- stats + output (on the stats worker when pipelined) ---
        if statq is not None:
            with span("wait.stats"):
                statq.put((b0, b1, fsc))
        else:
            self._stats_out(b0, b1, fsc)
        return ii

    def _pair(self, b0: list[Read], b1: list[Read],
              last_ii: IsizeInfo) -> IsizeInfo:
        """SE positions and mapQ, the insert-size estimate and the PE
        pairing of one batch; returns the batch's IsizeInfo."""
        opt, popt = self.opt, self.popt
        idx = self.idx
        fms = (idx.fm_fwd, idx.fm_rev)
        n = len(b0)
        alns_buf: list[list] = [[None] * n, [None] * n]

        # --- SE positions + mapQ (bwa_cal_pac_pos_pe SE part) ---
        for i in range(n):
            for j, p in enumerate((b0[i], b1[i])):
                p.n_multi = 0
                p.multi = []
                p.extra_flag |= SAM_FPD | (SAM_FR1 if j == 0 else SAM_FR2)
                if p.filtered:
                    continue
                alns_buf[j][i] = list(p.aln)
                bwa_aln2seq_core(p.aln, p, True, 0, self.rng)
                if p.type in (BWA_TYPE_UNIQUE, BWA_TYPE_REPEAT):
                    p.pos = sa_pos(fms, p.strand, p.sa, p.len)
                    max_diff = (bwa_cal_maxdiff(p.len, thres=opt.fnr)
                                if opt.fnr > 0.0 else opt.max_diff)
                    p.seQ = p.mapQ = bwa_approx_mapQ(p, max_diff)

        # --- infer isize ---
        ii = IsizeInfo()
        infer_isize(list(zip(b0, b1)), ii, popt.ap_prior, idx.l_pac)
        if ii.avg < 0.0 and last_ii.avg > 0.0:
            ii = copy.copy(last_ii)
        if popt.force_isize:
            notice("discard insert size estimate as user's request.")
            ii.low = ii.high = 0
            ii.avg = ii.std = -1.0

        # --- PE pairing ---
        for i in range(n):
            p = [b0[i], b1[i]]
            if p[0].filtered and p[1].filtered:
                continue
            d_aln = [alns_buf[0][i] or [], alns_buf[1][i] or []]
            if (p[0].type in (BWA_TYPE_UNIQUE, BWA_TYPE_REPEAT)
                    and p[1].type in (BWA_TYPE_UNIQUE, BWA_TYPE_REPEAT)):
                n_occ = [sum(r.l - r.k + 1 for r in d_aln[j]) for j in (0, 1)]
                if n_occ[0] <= popt.max_occ and n_occ[1] <= popt.max_occ:
                    arr = []
                    for j in (0, 1):
                        for k, r in enumerate(d_aln[j]):
                            if r.l - r.k + 1 >= MIN_HASH_WIDTH:
                                key = (r.k << 32) | r.l
                                if key not in self.g_hash:
                                    self.g_hash[key] = [
                                        sa_pos(fms, r.a, row, p[j].len)
                                        for row in range(r.k, r.l + 1)]
                                for x in self.g_hash[key]:
                                    arr.append((x << 32) | (k << 1) | j)
                            else:
                                for row in range(r.k, r.l + 1):
                                    x = sa_pos(fms, r.a, row, p[j].len)
                                    arr.append((x << 32) | (k << 1) | j)
                    pairing(p, d_aln, arr, popt, opt.s_mm, ii)
            # multi hits
            if popt.N_multi or popt.n_multi:
                for j in (0, 1):
                    if p[j].type != BWA_TYPE_NO_MATCH:
                        if (not (p[j].extra_flag & SAM_FPP)
                                and p[1 - j].type != BWA_TYPE_NO_MATCH):
                            nm = (popt.n_multi
                                  if p[j].c1 + p[j].c2 - 1 > popt.N_multi
                                  else popt.N_multi)
                            bwa_aln2seq_core(d_aln[j], p[j], False, nm, self.rng)
                        else:
                            bwa_aln2seq_core(d_aln[j], p[j], False,
                                             popt.n_multi, self.rng)
                        for q in p[j].multi:
                            q.pos = sa_pos(fms, q.strand, q.pos, p[j].len)
        return ii

    def _stats_out(self, b0: list[Read], b1: list[Read],
                   fsc: FileStat) -> None:
        opt, idx = self.opt, self.idx
        n = len(b0)
        with span("stats+out"):
            for i in range(n):
                p = [b0[i], b1[i]]
                fsc.num_base += p[0].full_len + p[1].full_len
                if p[0].filtered and p[1].filtered:
                    fsc.total_filtered += 1
                    continue
                if (p[0].type == BWA_TYPE_NO_MATCH
                        and p[1].type == BWA_TYPE_NO_MATCH):
                    fsc.bwa_unmapped += 1
                    continue
                fsc.total_retained += self.collector.add_alignment(
                    idx, p[0], p[1], opt, self.isize_out, fsc)
                if self.sam is not None:
                    self.sam.write_pair(idx, p[0], p[1], opt)
            fsc.num_read += 2 * n
            flush_batch(self.collector)

    def _refine_gapped(self, reads: list[Read]) -> None:
        """bwa_refine_gapped (libbwa/bwase.c:339-417)."""
        text = self.idx.text
        for s in reads:
            if s.filtered:
                continue
            # un-reverse seq back to forward orientation
            s.seq = np.concatenate([s.seq[: s.len][::-1], s.seq[s.len:]])
            for q in s.multi:
                if q.gap == 0:
                    continue
                seq = s.rseq if q.strand else s.seq
                ext = (1 if q.strand else -1) * q.gap
                q.cigar, q.pos = refine_gapped_core(text, s.len, seq, q.pos, ext)
            if (s.type in (BWA_TYPE_NO_MATCH, BWA_TYPE_MATESW)
                    or s.n_gapo == 0):
                pass
            else:
                seq = s.rseq if s.strand else s.seq
                ext = (1 if s.strand else -1) * (s.n_gapo + s.n_gape)
                s.cigar, s.pos = refine_gapped_core(text, s.len, seq, s.pos, ext)
                s.n_cigar = len(s.cigar)
        bwa_cal_md1_batch(
            [(s, s.rseq if s.strand else s.seq) for s in reads
             if not s.filtered and s.type != BWA_TYPE_NO_MATCH], text)
        for s in reads:
            # NB: the reference's trimming-correction loop has NO filtered
            # check (bwase.c:415-416) -- filtered reads get their length
            # restored too, which shows in the SAM of unrescued mates
            bwa_correct_trimmed(s)


class SingleEndMapper(PairEndMapper):
    def run(self, fq1: str, fq2: str, fsc: FileStat,
            batch_size: int = READ_BUFFER_SIZE) -> None:
        import threading

        opt = self.opt
        idx = self.idx
        fms = (idx.fm_fwd, idx.fm_rev)
        reader, native = self._open_reader(fq1)
        nxt: list = [None]

        def prefetch(rno):
            nxt[0] = self._next_batch(reader, native, batch_size, rno)

        batch = self._next_batch(reader, native, batch_size, 0)
        round_no = 1
        while True:
            if not batch:
                break
            self.batches += 1
            th = threading.Thread(target=prefetch, args=(round_no,))
            th.start()
            round_no += 1
            self.engine.align_batch(batch, opt)
            for p in batch:
                fsc.num_base += p.full_len
                if p.filtered:
                    continue
                bwa_aln2seq_core(p.aln, p, True, 3, self.rng)  # N_OCC=3
            # positions (bwa_cal_pac_pos, src/BwtMapper.cpp:294-328)
            for p in batch:
                if p.filtered or p.type not in (BWA_TYPE_UNIQUE,
                                                BWA_TYPE_REPEAT):
                    continue
                p.pos = sa_pos(fms, p.strand, p.sa, p.len)
                max_diff = (bwa_cal_maxdiff(p.len, thres=opt.fnr)
                            if opt.fnr > 0.0 else opt.max_diff)
                p.seQ = p.mapQ = bwa_approx_mapQ(p, max_diff)
                for q in p.multi:
                    q.pos = sa_pos(fms, q.strand, q.pos, p.len)
            self._refine_gapped(batch)
            for p in batch:
                if p.filtered:
                    fsc.total_filtered += 1
                    continue
                if p.type == BWA_TYPE_NO_MATCH:
                    fsc.bwa_unmapped += 1
                    continue
                fsc.total_retained += self.collector.add_alignment(
                    self.idx, p, None, opt, self.isize_out, fsc)
                if self.sam is not None:
                    self.sam.write_pair(self.idx, p, None, opt)
            fsc.num_read += len(batch)
            flush_batch(self.collector)
            th.join()
            batch = nxt[0]
        reader.close()


def run_align(argv: list[str]) -> int:
    """`align`: the call's spans (utils/spans.py) add into one tally,
    published in LAST_RUN_STATS once the call's own span has closed."""
    with call() as tally:
        stats = _run_align(argv)
    stage_t = tally.seconds()
    LAST_RUN_STATS.clear()
    LAST_RUN_STATS.update(stats, stage_t=stage_t)
    notice("Align phase times (threads overlap; a span holds its "
           "children): %s", ", ".join(
               f"{k} {v:.2f}s" for k, v in
               sorted(stage_t.items(), key=lambda kv: -kv[1])))
    if "bam.write" in stage_t:
        notice("BAM writer thread busy: %.2fs (record packing + deflate, "
               "overlapped with the phases above)", stage_t["bam.write"])
    return 0


def _run_align(argv: list[str]) -> dict:
    t_real = realtime()
    pl = ParamList()
    pl.group("Input/Output Files")
    pl.add("fastq_1", "Empty", "Pair end 1 fastq file")
    pl.add("fastq_2", "Empty", "Pair end 2 fastq file")
    pl.add("fq_list", "Empty", "Tab-delimited list of fastq files")
    pl.add("bam_in", "Empty", "Input bam file path")
    pl.add("sam_out", False, "Output SAM instead of BAM")
    pl.add("device_filter", False, "run the k-mer read filter on the "
           "accelerator (HBM-resident bitmaps) instead of the CPU")
    pl.add("device_qc", False, "resident-on-chip QC mode: the k-mer "
           "filter, the inexact search and the dense per-base statistics "
           "run as device programs (index/bitmaps/site tables uploaded "
           "once); pairing/rescue/refine and all writers stay host-side, "
           "so the BAM and all 14 output files are byte-identical to the "
           "host pipeline")
    pl.add("out_prefix", "Empty", "Prefix of all the output files")
    pl.add("index_prefix", "Empty", "Input prefix of the index files")
    pl.group("Parameters for Alignment")
    pl.add("kmer_thresh", 3, "number of k-mer tests to pass")
    pl.add("n", 0.02, "max #diff or missing prob", type_=float)
    pl.add("o", 1, "maximum number of gap opens")
    pl.add("e", -1, "maximum number of gap extensions")
    pl.add("i", 5, "indel end skip")
    pl.add("d", 10, "max occurrences for long deletion extension")
    pl.add("l", 32, "seed length")
    pl.add("k", 2, "maximal seed difference")
    pl.add("m", 2000000, "maximal stack entries")
    pl.add("t", 4, "number of threads (engine batches are data-parallel)")
    pl.add("R", 30, "stop searching when >INT equally best hits")
    pl.add("q", 0, "quality threshold for read trimming")
    pl.add("RG", "@RG\tID:foo\tSM:bar", "ReadGroup name")
    pl.add("N", False, "non-iterative mode")
    pl.add("I", False, "Illumina 1.3+ quality format")
    pl.add("L", False, "log-scaled gap penalty")
    pl.group("Additional Parameters for PairEnd")
    pl.add("max_isize", 500, "maximum insert size")
    pl.add("max_occ", 100000, "maximum occurrences of one end")
    pl.add("is_sw", True, "enable Smith-Waterman for unmapped mates")
    pl.add("n_multi", 3, "max hits for paired reads")
    pl.add("N_multi", 10, "max hits for discordant pairs")
    pl.add("ap_prior", 1e-5, "prior of chimeric rate")
    pl.add("force_isize", False, "disable insert size estimate")
    pl.group("Parameters for Statistics")
    pl.add("cal_dup", True, "enable duplicate calculation")
    pl.add("frac_samp", 1.0, "downsampling fraction")
    pl.group("Engine")
    pl.add("engine", "auto", "alignment engine: host | native | device | "
           "auto (auto = the device QC path on cuda, native or host on cpu)")
    pl.add("device", "cuda", "torch device of the device path: cuda | cpu "
           "(cpu runs the plain PyTorch versions of the kernels)")
    pl.group("Multi-host sharding")
    pl.add("shard_out", False, "write <out_prefix>.shard.npz accumulator "
           "state instead of final statistics (merge shards with "
           "`fastquick-torch merge`)")
    pl.read(argv)
    pl.status()

    with span("call.setup"):
        from ..utils.device import resolve_device

        device = resolve_device(pl["device"])  # raises for cuda without CUDA

        if pl["out_prefix"] == "Empty":
            error("--out_prefix is required")
        if pl["index_prefix"] == "Empty":
            error("--index_prefix is required")
        if pl["bam_in"] != "Empty":
            # parity with the reference (src/BwtMapper.cpp:186):
            error("Input alignments from Bam file is disabled.")

        prefix = pl["out_prefix"]
        new_ref, opt, params = index_options(pl["index_prefix"])
        popt = PeOpt()
        opt.fnr = pl["n"]
        if opt.fnr >= 1.0:
            opt.max_diff = int(opt.fnr)
            opt.fnr = -1.0
        opt.max_gapo = pl["o"]
        if pl["e"] > 0:
            opt.max_gape = pl["e"]
            opt.mode &= ~BWA_MODE_GAPE
        opt.indel_end_skip = pl["i"]
        opt.max_del_occ = pl["d"]
        opt.seed_len = pl["l"]
        opt.max_seed_diff = pl["k"]
        opt.max_entries = pl["m"]
        opt.n_threads = pl["t"]
        opt.max_top2 = pl["R"]
        opt.trim_qual = pl["q"]
        if pl["N"]:
            opt.mode |= BWA_MODE_NONSTOP
            opt.max_top2 = 0x7FFFFFFF
        if pl["I"]:
            opt.mode |= BWA_MODE_IL13
        if pl["L"]:
            opt.mode |= BWA_MODE_LOGGAP
        opt.frac = pl["frac_samp"]
        opt.cal_dup = 1 if pl["cal_dup"] else 0
        popt.max_isize = pl["max_isize"]
        popt.max_occ = pl["max_occ"]
        popt.is_sw = 1 if pl["is_sw"] else 0
        popt.n_multi = pl["n_multi"]
        popt.N_multi = pl["N_multi"]
        popt.ap_prior = pl["ap_prior"]
        popt.force_isize = 1 if pl["force_isize"] else 0

        t_tmp = realtime()
        idx = load_index(new_ref)
        idx.kmer.thresh = pl["kmer_thresh"]
        notice("Index loaded in %f sec", realtime() - t_tmp)

        contig_sizes = load_contig_sizes(params["REFERENCE_PATH"])[0]
        collector = sample_collector(new_ref, opt, params)

        fq_pairs: list[tuple[str, str]] = []
        if pl["fq_list"] != "Empty":
            with open(pl["fq_list"]) as fh:
                for line in fh:
                    if line.startswith("#") or not line.strip():
                        continue
                    parts = line.split()
                    fq_pairs.append(
                        (parts[0], parts[1] if len(parts) > 1 else ""))
        elif pl["fastq_1"] != "Empty":
            fq_pairs.append((pl["fastq_1"], pl["fastq_2"]
                             if pl["fastq_2"] != "Empty" else ""))
        else:
            error("One of --fq_list / --fastq_1 is required")

        device_qc = pl["device_qc"]
        engine_kind = pl["engine"]
        if not device_qc and engine_kind in ("auto", "device") \
                and device.type == "cuda":
            # a CUDA device engages the device QC path (the reference driver
            # always runs its one CPU engine, bin/FASTQuick_template.sh:
            # 465-496); --device cpu keeps the native/host engine for auto
            device_qc = True
        if device_qc:
            # product-grade resident mode: device k-mer filter + device
            # search engine + device dense-stat accumulation; pairing /
            # refine / pileup strings / output writers stay on the host, so
            # every product file is byte-identical to the host pipeline
            from .device_qc import DeviceDenseStats

            notice("Resident-on-chip QC mode (device filter+search+stats)")
            collector.dense_device = DeviceDenseStats(idx, collector, opt,
                                                      device)
            engine_kind = "device"
        if engine_kind == "device":
            from ..ops.batch_search import BatchEngine

            engine = BatchEngine(idx, device=device)
            notice("Device search kernel: %s (pool %d%s)", engine.kernel,
                   engine.pool,
                   f", {engine.lanes} lanes x {engine.inner} steps"
                   if engine.kernel == "scan" else "")
        elif engine_kind == "native":
            engine = NativeEngine(idx)
        elif engine_kind == "auto":
            engine = exact_engine(idx)
            engine_kind = ("native" if isinstance(engine, NativeEngine)
                           else "host")
        else:
            engine = HostEngine(idx)
        notice("Using %s alignment engine on %s", engine_kind, device)

        sam = _SamWriter(prefix, contig_sizes, pl["RG"],
                         bam=not pl["sam_out"])
        isize_out = open(prefix + ".InsertSizeTable", "w")

    use_dev_filter = pl["device_filter"] or device_qc
    # batches: read batches aligned, over every FASTQ pair of the call
    stats: dict = dict(engine=engine_kind, device=str(device), batches=0)
    for fq1, fq2 in fq_pairs:
        if fq2:
            notice("Processing Pair End mapping\t%s\t%s", fq1, fq2)
            fsc = FileStat(file_name1=fq1, file_name2=fq2)
            mapper = PairEndMapper(idx, engine, opt, popt, collector, sam,
                                   isize_out,
                                   device_filter=use_dev_filter,
                                   device=device, device_sw=device_qc)
            mapper.run(fq1, fq2, fsc)
        else:
            notice("Processing Single End mapping\t%s", fq1)
            fsc = FileStat(file_name1=fq1, file_name2=fq1)
            mapper = SingleEndMapper(idx, engine, opt, popt, collector, sam,
                                     isize_out,
                                     device_filter=use_dev_filter,
                                     device=device, device_sw=device_qc)
            mapper.run(fq1, "", fsc)
        collector.add_fsc(fsc)
        stats["batches"] += mapper.batches
        notice("%d sequences loaded, %d filtered, %d unmapped, %d retained "
               "(%d read batches)", fsc.num_read, fsc.total_filtered,
               fsc.bwa_unmapped, fsc.total_retained, mapper.batches)

    with span("call.finish"):
        isize_out.close()
        sam.close()
        if engine_kind == "device":
            stats.update(searched=engine.reads_searched,
                         fallback=engine.reads_fallback,
                         fb_causes=dict(engine.fb_causes),
                         search_kernel=engine.kernel,
                         rounds=engine.rounds, busy=engine.busy)
            notice("Device search (%s kernel): %d reads searched, %d redone "
                   "exactly on the host (causes: %s); %d outer rounds, %d "
                   "busy steps", engine.kernel, engine.reads_searched,
                   engine.reads_fallback,
                   ", ".join(f"{k} {v}" for k, v in
                             sorted(engine.fb_causes.items())) or "none",
                   engine.rounds, engine.busy)
        t_tmp = realtime()
        if pl["shard_out"]:
            from ..stats.shard import save_shard

            # save_shard's flush_dense also adds the device-QC dense sums
            save_shard(collector, prefix + ".shard.npz")
            notice("Shard state written to %s.shard.npz (merge with "
                   "`fastquick-torch merge`)", prefix)
        else:
            collector.process_core(prefix, opt)
            notice("Calculate distributions... %f sec", realtime() - t_tmp)
    notice("Real time: %.3f sec", realtime() - t_real)
    return stats


def run_merge(argv: list[str]) -> int:
    """fastquick-torch merge: combine shard accumulator states + insert-size
    tables from N independent align runs into the final statistics."""
    pl = ParamList()
    pl.add("index_prefix", "Empty", "index prefix (as used by the shards)")
    pl.add("out_prefix", "Empty", "output prefix for the merged statistics")
    shard_prefixes = pl.read(argv)
    pl.status()
    if pl["index_prefix"] == "Empty" or pl["out_prefix"] == "Empty":
        error("--index_prefix and --out_prefix are required")
    if not shard_prefixes:
        error("pass the shard output prefixes as positional arguments")

    from ..stats.shard import merge_shards

    new_ref, opt, params = index_options(pl["index_prefix"])
    collector = sample_collector(new_ref, opt, params)
    merge_shards(collector, [p + ".shard.npz" for p in shard_prefixes])
    with open(pl["out_prefix"] + ".InsertSizeTable", "w") as out:
        for p in shard_prefixes:
            with open(p + ".InsertSizeTable") as fh:
                out.write(fh.read())
    collector.process_core(pl["out_prefix"], opt)
    notice("Merged %d shards into %s", len(shard_prefixes), pl["out_prefix"])
    return 0
