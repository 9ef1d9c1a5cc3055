"""Device dense statistics for ``align --device_qc``.

Counterpart of fastquick_tpu/align/device_qc.py.  In device-QC mode the
k-mer filter, the inexact search and the per-base dense-site statistics
run on the device; drand48 hit draws, pairing, mate rescue (whose SW
forward passes run on the device too), gapped refine, the marker pileup
strings and every writer stay on the host, so the BAM and all 14
statistics files are byte-identical to the host pipeline.

DeviceDenseStats takes every eligible ungapped full-length read that
StatCollector._drain_queue routes to it and sums pac positions -> site
indices -> depth/Q20/Q30 plus the empirical quality/cycle (mis)match
histograms on the device: one launch of the dense accumulation kernel a
chunk of reads (ops/accumulate.dense_accumulate, csrc/accumulate.cu; its
plain version, integer ``index_add_``, on the CPU).  Commutative integer
sums, so device == host exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.accumulate import dense_accumulate, unpack_dense
from ..ops.site_tables import build_site_tables
from ..utils.device import resolve_device
from ..utils.logging import notice

_PAD_B = 4096  # reads per accumulation call
_PAD_L = 256  # read bases kept per read (longer reads are clipped, as in
# the reference device path)


class DeviceDenseStats:
    """Device backend for StatCollector's dense-site accumulation.

    collector._drain_queue routes every eligible ungapped full-length read
    here; flush() runs the accumulation and adds the integer results into
    the collector's arrays.  Inputs are reference-oriented codes/quals, so
    the site/mismatch/cycle math matches AddSingleAlignment's walk
    (src/StatCollector.cpp:437-618) exactly."""

    def __init__(self, idx, collector, opt,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.tables = build_site_tables(idx, collector, opt, self.device)
        self.S = self.tables.n_sites
        self.n_text = idx.l_pac
        self._pos: list[int] = []
        self._strand: list[int] = []
        self._len: list[int] = []
        self._codes: list[np.ndarray] = []
        self._quals: list[np.ndarray] = []
        self.reads_accumulated = 0

    def add(self, p) -> None:
        """Queue one eligible ungapped full-length read (called from
        _drain_queue in arrival order; sums are commutative)."""
        ln = p.len
        if p.strand == 0:
            codes = p.seq[:ln].astype(np.uint8)
            quals = p.qual[:ln].astype(np.uint8) - 33
        else:
            c = p.seq[:ln][::-1]
            codes = np.where(c < 4, 3 - c, 4).astype(np.uint8)
            quals = p.qual[:ln][::-1].astype(np.uint8) - 33
        self._pos.append(p.pos)
        self._strand.append(int(p.strand))
        self._len.append(ln)
        self._codes.append(codes)
        self._quals.append(quals)
        self.reads_accumulated += 1

    def flush(self, collector) -> None:
        if not self._pos:
            return
        n = len(self._pos)
        dev = self.device
        for lo in range(0, n, _PAD_B):
            hi = min(lo + _PAD_B, n)
            m = hi - lo
            L = min(max(self._len[lo:hi]), _PAD_L)
            codes = np.full((m, L), 4, np.uint8)
            quals = np.zeros((m, L), np.uint8)
            lens = np.zeros(m, np.int64)
            for i in range(m):
                k = lo + i
                ln = min(self._len[k], _PAD_L)
                codes[i, :ln] = self._codes[k][:ln]
                quals[i, :ln] = self._quals[k][:ln]
                lens[i] = ln
            pos = np.asarray(self._pos[lo:hi], np.int64)
            strand = np.asarray(self._strand[lo:hi], np.int64)
            # one packed int32 output a chunk, one copy to the host; the
            # collector's int64 arrays widen it
            out = unpack_dense(dense_accumulate(
                self.tables, self.n_text, torch.from_numpy(pos).to(dev),
                torch.from_numpy(strand).to(dev),
                torch.from_numpy(codes).to(dev),
                torch.from_numpy(quals).to(dev),
                torch.from_numpy(lens).to(dev)).cpu().numpy(), self.S)
            collector.sites.depth += out["depth"]
            collector.sites.q20 += out["q20"]
            collector.sites.q30 += out["q30"]
            collector.emp_rep_dist += out["emp_rep"]
            collector.emp_cycle_dist += out["emp_cycle"]
            collector.mis_emp_rep_dist += out["mis_emp_rep"]
            collector.mis_emp_cycle_dist += out["mis_emp_cycle"]
        self._pos.clear()
        self._strand.clear()
        self._len.clear()
        self._codes.clear()
        self._quals.clear()

    def report(self) -> None:
        notice("Device dense accumulation: %d reads", self.reads_accumulated)
