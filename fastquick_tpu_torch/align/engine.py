"""Alignment engines: fill Read.aln for a batch of reads.

The HostEngine runs the exact-semantics search from core.py read by read
(the behavioral oracle).  The TPU engine (ops/batch_search.py) runs the
same state machine batched across reads under jit and is differential-
tested against this one.
"""

from __future__ import annotations

import numpy as np

from ..index.builder import ReducedIndex
from .core import GapStack, bwt_cal_width, bwt_match_gap
from .opts import GapOpt, bwa_cal_maxdiff
from .seqs import Read


class NativeEngine:
    """C++ exact search engine (native/aligner.cpp) over the packed index;
    redoes hit-list overflows (>256 hits) with the Python oracle."""

    OUT_CAP = 256
    _scratch = None

    def __init__(self, idx: ReducedIndex):
        import ctypes

        from ..native import get_aligner_lib

        self.idx = idx
        self._lib = get_aligner_lib()
        if self._lib is None:
            raise RuntimeError("native aligner unavailable")
        self._host = HostEngine(idx)

        def prep(fm):
            words = np.ascontiguousarray(
                np.concatenate([fm.bwt_words,
                                np.zeros(8, np.uint32)]))
            occ = np.ascontiguousarray(fm.occ.astype(np.int32))
            sa = np.ascontiguousarray(fm.sa.astype(np.int32))
            L2 = np.ascontiguousarray((fm.C[:4] - 1).astype(np.int32))
            return words, occ, sa, L2, np.int32(fm.primary)

        self._keep = [prep(idx.fm_fwd), prep(idx.fm_rev)]
        f, r = self._keep
        cp = ctypes.c_void_p
        self._h = self._lib.aln_create(
            f[0].ctypes.data_as(cp), f[1].ctypes.data_as(cp),
            f[2].ctypes.data_as(cp), f[3].ctypes.data_as(cp), int(f[4]),
            r[0].ctypes.data_as(cp), r[1].ctypes.data_as(cp),
            r[2].ctypes.data_as(cp), r[3].ctypes.data_as(cp), int(r[4]),
            idx.fm_fwd.n)

    def align_batch(self, reads: list[Read], opt: GapOpt) -> None:
        import ctypes

        from .core import Aln

        for p in reads:
            p.sa = 0
            p.type = 0
            p.c1 = p.c2 = 0
            p.n_aln = 0
            p.aln = []
        todo = [p for p in reads if not p.filtered]
        if not todo:
            return
        B = len(todo)
        L = max(p.len for p in todo)
        # reused scratch: a fresh 235MB zeroed hit buffer per call costs
        # more (memset + page faults) than the alignment of small batches;
        # the C engine only writes rows [0, out_n) per read and the
        # extraction below only reads those
        # (the C engine strides by exactly 2*L per read, so reuse needs
        # an exact L match; B may shrink -- leading rows stay contiguous)
        sc = self._scratch
        if sc is None or sc[0].shape[0] < B or sc[0].shape[2] != L:
            sc = (np.empty((B, 2, L), dtype=np.uint8),
                  np.empty(B, dtype=np.int32),
                  np.empty(B, dtype=np.int32),
                  np.empty(B, dtype=np.int32),
                  np.empty((B, self.OUT_CAP, 7), dtype=np.int32))
            self._scratch = sc
        seqs, lens, mds, out_n, out = sc
        seqs[:B] = 4
        for b, p in enumerate(todo):
            seqs[b, 0, : p.len] = p.seq[: p.len]
            seqs[b, 1, : p.len] = p.rseq[: p.len]
            lens[b] = p.len
            mds[b] = (bwa_cal_maxdiff(p.len, thres=opt.fnr)
                      if opt.fnr > 0.0 else opt.max_diff)
        batch_md = (bwa_cal_maxdiff(int(L), thres=opt.fnr)
                    if opt.fnr > 0.0 else opt.max_diff)
        max_gapo = min(opt.max_gapo, batch_md)
        cp = ctypes.c_void_p
        self._lib.aln_batch(
            self._h, seqs.ctypes.data_as(cp), lens.ctypes.data_as(cp),
            mds.ctypes.data_as(cp), B, L, opt.s_mm, opt.s_gapo, opt.s_gape,
            int(max_gapo), opt.max_gape, opt.indel_end_skip, opt.max_del_occ,
            opt.max_entries, opt.max_top2, opt.seed_len, opt.max_seed_diff,
            out_n.ctypes.data_as(cp), out.ctypes.data_as(cp), self.OUT_CAP)
        # gather all hit rows in one vectorized pass (per-read numpy
        # slicing costs more than the hits themselves at ~1 hit/read)
        counts = np.maximum(out_n[:B], 0)
        tot = int(counts.sum())
        if tot:
            b_rep = np.repeat(np.arange(B), counts)
            within = (np.arange(tot)
                      - np.repeat(np.cumsum(counts) - counts, counts))
            rows = out[b_rep, within].tolist()
        else:
            rows = []
        redo = []
        pos = 0
        for b, p in enumerate(todo):
            nb = int(out_n[b])
            if nb < 0:
                redo.append(p)
                continue
            p.aln = [Aln(*rows[j]) for j in range(pos, pos + nb)]
            pos += nb
            p.n_aln = nb
        if redo:
            self._host.align_batch(redo, opt)


class HostEngine:
    """bwa_cal_sa_reg_gap equivalent (reference src/BwtMapper.cpp:63-168)."""

    def __init__(self, idx: ReducedIndex):
        self.idx = idx
        self.fms = (idx.fm_fwd, idx.fm_rev)

    def align_batch(self, reads: list[Read], opt: GapOpt) -> None:
        import copy

        local_opt = copy.copy(opt)
        max_len = max((r.len for r in reads), default=0)
        if opt.fnr > 0.0:
            local_opt.max_diff = bwa_cal_maxdiff(max_len, thres=opt.fnr)
        if local_opt.max_diff < local_opt.max_gapo:
            local_opt.max_gapo = local_opt.max_diff
        stack = GapStack(local_opt.max_diff, local_opt.max_gapo,
                         local_opt.max_gape, local_opt)
        seed_w = (np.zeros((opt.seed_len + 1, 2), dtype=np.int64),
                  np.zeros((opt.seed_len + 1, 2), dtype=np.int64))
        w = (np.zeros((max_len + 1, 2), dtype=np.int64),
             np.zeros((max_len + 1, 2), dtype=np.int64))
        for p in reads:
            p.sa = 0
            p.type = 0
            p.c1 = p.c2 = 0
            p.n_aln = 0
            p.aln = []
            if p.filtered:
                continue
            seqs = (p.seq, p.rseq)
            w[0][: p.len + 1] = 0
            w[1][: p.len + 1] = 0
            bwt_cal_width(self.fms[0], p.len, seqs[0], w[0])
            bwt_cal_width(self.fms[1], p.len, seqs[1], w[1])
            if opt.fnr > 0.0:
                local_opt.max_diff = bwa_cal_maxdiff(p.len, thres=opt.fnr)
            local_opt.seed_len = (opt.seed_len if opt.seed_len < p.len
                                  else 0x7FFFFFFF)
            if p.len > opt.seed_len:
                seed_w[0][:] = 0
                seed_w[1][:] = 0
                bwt_cal_width(self.fms[0], opt.seed_len,
                              seqs[0][p.len - opt.seed_len:], seed_w[0])
                bwt_cal_width(self.fms[1], opt.seed_len,
                              seqs[1][p.len - opt.seed_len:], seed_w[1])
            p.aln = bwt_match_gap(
                self.fms, p.len, seqs, w,
                None if p.len <= opt.seed_len else seed_w, local_opt, stack)
            p.n_aln = len(p.aln)
