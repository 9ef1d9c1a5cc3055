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
histograms with integer ``index_add_`` on the device: commutative integer
sums, so device == host exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.site_tables import build_site_tables
from ..utils.device import resolve_device
from ..utils.logging import notice

_PAD_B = 4096  # reads per accumulation call
_PAD_L = 256  # read bases kept per read (longer reads are clipped, as in
# the reference device path)


def dense_accumulate(tab, n_text: int, pos: torch.Tensor,
                     strand: torch.Tensor, codes: torch.Tensor,
                     quals: torch.Tensor, lens: torch.Tensor):
    """One accumulation program over a (B, L) batch of reference-oriented
    codes/quals.  Returns int64 (dense3 (3*(S+1),), emp_rep, emp_cyc,
    mis_rep, mis_cyc (256,) each)."""
    S = tab.n_sites
    dev = codes.device
    B, L = codes.shape
    offs = torch.arange(L, dtype=torch.long, device=dev)[None, :]
    lens = lens.long()
    cover = offs < lens[:, None]
    pacp = torch.where(cover, pos.long()[:, None] + offs, n_text)
    pacp = pacp.clamp(0, n_text)
    site = tab.site_idx[pacp].long()
    in_reg = cover & (site >= 0)
    site_c = torch.where(in_reg, site, S)
    fb = tab.text[pacp].long()
    codes = codes.long()
    bq = quals.long().clamp(0, 255)
    mism = in_reg & (codes < 4) & (fb < 4) & (codes != fb)
    dbsnp_g = torch.cat([tab.dbsnp, torch.zeros(1, dtype=torch.bool,
                                                device=dev)])
    mism = mism & ~dbsnp_g[site_c.clamp(0, S)]
    cycle = torch.where((strand == 1)[:, None], lens[:, None] - 1 - offs,
                        offs)
    ones = in_reg.long().reshape(-1)
    tier = ((bq >= 20).long() + (bq >= 30).long()).reshape(-1)
    dense3 = torch.zeros(3 * (S + 1), dtype=torch.long, device=dev)
    dense3.index_add_(0, site_c.reshape(-1) + tier * (S + 1), ones)
    bq_f = torch.where(in_reg, bq, 255).reshape(-1)
    cy_f = torch.where(in_reg, cycle.clamp(0, 255), 255).reshape(-1)
    m_ones = mism.long().reshape(-1)

    def hist(idx, val):
        return torch.zeros(256, dtype=torch.long, device=dev).index_add_(
            0, idx, val)

    return (dense3, hist(bq_f, ones), hist(cy_f, ones), hist(bq_f, m_ones),
            hist(cy_f, m_ones))


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
            lens = np.zeros(m, np.int32)
            for i in range(m):
                k = lo + i
                ln = min(self._len[k], _PAD_L)
                codes[i, :ln] = self._codes[k][:ln]
                quals[i, :ln] = self._quals[k][:ln]
                lens[i] = ln
            pos = np.asarray(self._pos[lo:hi], np.int64)
            strand = np.asarray(self._strand[lo:hi], np.int64)
            dense3, emp_rep, emp_cyc, mis_rep, mis_cyc = [
                x.cpu().numpy() for x in dense_accumulate(
                    self.tables, self.n_text,
                    torch.from_numpy(pos).to(dev),
                    torch.from_numpy(strand).to(dev),
                    torch.from_numpy(codes).to(dev),
                    torch.from_numpy(quals).to(dev),
                    torch.from_numpy(lens).to(dev))]
            S = self.S
            c0, c1, c2 = (dense3[:S], dense3[S + 1:2 * S + 1],
                          dense3[2 * S + 2:][:S])
            q20 = c1 + c2
            collector.sites.depth += c0 + q20
            collector.sites.q20 += q20
            collector.sites.q30 += c2
            collector.emp_rep_dist += emp_rep
            collector.emp_cycle_dist += emp_cyc
            collector.mis_emp_rep_dist += mis_rep
            collector.mis_emp_cycle_dist += mis_cyc
        self._pos.clear()
        self._strand.clear()
        self._len.clear()
        self._codes.clear()
        self._quals.clear()

    def report(self) -> None:
        notice("Device dense accumulation: %d reads", self.reads_accumulated)
