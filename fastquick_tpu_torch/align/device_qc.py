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
histograms on the device: one launch of the accumulation walk a chunk of
reads (ops/accumulate.dense_accumulate, csrc/accumulate.cu; its plain
version, integer ``index_add_``, on the CPU), added to int32 counters
that stay on the device.  They go to the host, into the collector's int64
arrays, when a flush is not deferred (``deferred``; the driver defers its
flush at each batch end, so the run drains when the collector's arrays
are read: process_core, save_shard).  Commutative integer sums, so
device == host exactly.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ops.accumulate import dense_accumulate, dense_size, unpack_dense
from ..ops.site_tables import build_site_tables
from ..utils.device import resolve_device
from ..utils.logging import notice

_PAD_B = 4096  # reads per accumulation call
_PAD_L = 256  # read bases kept per read (longer reads are clipped, as in
# the reference device path)
# The resident counters are int32 and exact: a base adds at most one to any
# counter (its site's depth, q20 and q30, one bin of each histogram,
# n_base_mapped), so no counter has grown by more than the grid cells
# (reads x L) launched since the last drain, and a flush drains before
# that count would pass 2^31 - 1.  The collector's int64 sums take each
# drained value as it is.
DRAIN_CELLS = 2 ** 31 - 1


class DeviceDenseStats:
    """Device backend for StatCollector's dense-site accumulation.

    collector._drain_queue routes every eligible ungapped full-length read
    here; flush() runs the accumulation into the device's counters and,
    unless deferred, adds them into the collector's arrays.  Inputs are
    reference-oriented codes/quals, so the site/mismatch/cycle math
    matches AddSingleAlignment's walk (src/StatCollector.cpp:437-618)
    exactly."""

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
        self._sums: torch.Tensor | None = None  # the resident counters
        self._cells = 0  # grid cells launched since the last drain
        self._defer = False
        self.drains = 0

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

    @contextlib.contextmanager
    def deferred(self):
        """Flushes inside the block leave the sums on the device."""
        self._defer = True
        try:
            yield
        finally:
            self._defer = False

    def flush(self, collector) -> None:
        """Accumulate the queued reads (one launch a chunk of _PAD_B) and,
        unless deferred, drain the device's sums into the collector."""
        n = len(self._pos)
        dev = self.device
        for lo in range(0, n, _PAD_B):
            hi = min(lo + _PAD_B, n)
            m = hi - lo
            L = min(max(self._len[lo:hi]), _PAD_L)
            if self._cells + m * L > DRAIN_CELLS:
                self._drain(collector)
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
            if self._sums is None:
                self._sums = torch.zeros(dense_size(self.S),
                                         dtype=torch.int32, device=dev)
            dense_accumulate(
                self.tables, self.n_text, torch.from_numpy(pos).to(dev),
                torch.from_numpy(strand).to(dev),
                torch.from_numpy(codes).to(dev),
                torch.from_numpy(quals).to(dev),
                torch.from_numpy(lens).to(dev), out=self._sums)
            self._cells += m * L
        self._pos.clear()
        self._strand.clear()
        self._len.clear()
        self._codes.clear()
        self._quals.clear()
        if not self._defer:
            self._drain(collector)

    def _drain(self, collector) -> None:
        """The device's sums into the collector's int64 arrays (one copy),
        then zeroed."""
        if not self._cells:
            return
        out = unpack_dense(self._sums.cpu().numpy(), self.S)
        collector.sites.depth += out["depth"]
        collector.sites.q20 += out["q20"]
        collector.sites.q30 += out["q30"]
        collector.emp_rep_dist += out["emp_rep"]
        collector.emp_cycle_dist += out["emp_cycle"]
        collector.mis_emp_rep_dist += out["mis_emp_rep"]
        collector.mis_emp_cycle_dist += out["mis_emp_cycle"]
        self._sums.zero_()
        self._cells = 0
        self.drains += 1

    def report(self) -> None:
        notice("Device dense accumulation: %d reads, %d drains to the host",
               self.reads_accumulated, self.drains)


def flush_batch(collector) -> None:
    """collector.flush_dense() at a batch end: a DeviceDenseStats
    backend's sums stay on the device until the collector's arrays are
    read (the next flush that is not deferred: process_core,
    save_shard)."""
    dev = getattr(collector, "dense_device", None)
    with dev.deferred() if dev is not None else contextlib.nullcontext():
        collector.flush_dense()
