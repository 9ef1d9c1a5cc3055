"""Pac-coordinate site tables for the device dense statistics.

Counterpart of ``SiteTables`` / ``build_site_tables`` in
fastquick_tpu/ops/qc_full.py:75-135, returning torch tensors; the port's
ops/qc_full re-exports both, as the reference module defines them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.device import resolve_device


@dataclass(frozen=True)
class SiteTables:
    """Pac-coordinate site tables on one device.

    Index n_text is the out-of-range guard row (site -1, marker -1)."""

    site_idx: torch.Tensor   # (n+1,) int32: dense-site index or -1
    marker_id: torch.Tensor  # (n+1,) int32: marker index or -1
    text: torch.Tensor       # (n+1,) int32 codes (guard row 4)
    dbsnp: torch.Tensor      # (S,) bool over the dense site space
    is_xy: torch.Tensor      # (n+1,) bool: position on an X/Y contig
    contig_id: torch.Tensor  # (n+1,) int32: contig index (guard row -1)
    contig_off: torch.Tensor  # (C,) int32: contig pac offsets
    contig_len: torch.Tensor  # (C,) int32: contig lengths
    n_sites: int
    n_markers: int

    @classmethod
    def from_numpy(cls, site_idx, marker_id, text, dbsnp, is_xy, contig_id,
                   contig_off, contig_len, n_sites: int, n_markers: int,
                   device: str | torch.device = "cpu") -> "SiteTables":
        """The tables from arrays (the fields of the reference package's
        SiteTables, in its order), int32 and bool, on `device`."""
        def put(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype),
                                   device=device)

        i32 = np.int32
        return cls(site_idx=put(site_idx, i32), marker_id=put(marker_id, i32),
                   text=put(text, i32), dbsnp=put(dbsnp, bool),
                   is_xy=put(is_xy, bool), contig_id=put(contig_id, i32),
                   contig_off=put(contig_off, i32),
                   contig_len=put(contig_len, i32), n_sites=int(n_sites),
                   n_markers=int(n_markers))


def build_site_tables(idx, sc, opt,
                      device: str | torch.device = "cuda") -> SiteTables:
    """Build pac-space tables from a ReducedIndex + a StatCollector that
    has run restore_vcf_sites (mirrors the coordinate math of
    add_single_alignment: real = contig.pos - flank + (pac - offset)), on
    `device` (the card unless "cpu"; cuda without CUDA raises)."""
    device = resolve_device(device)
    n = idx.l_pac
    site_idx = np.full(n + 1, -1, np.int32)
    marker_id = np.full(n + 1, -1, np.int32)
    is_xy = np.zeros(n + 1, bool)
    contig_id = np.full(n + 1, -1, np.int32)
    sites = sc.sites
    for ci, contig in enumerate(idx.contigs):
        contig_id[contig.offset:contig.offset + contig.length] = ci
        flank = opt.flank_long_len if contig.is_long else opt.flank_len
        start_real = contig.pos - flank  # 1-based real coord of pac offset
        chrom = contig.chrom[3:] if contig.chrom.startswith("chr") \
            else contig.chrom
        pos1, didx = sites.index_range(
            chrom, start_real, start_real + contig.length)
        pac = contig.offset + (pos1 - start_real)
        ok = (pac >= 0) & (pac < n)
        site_idx[pac[ok]] = didx[ok]
        # marker position -> pac coordinate
        mpac = contig.offset + (contig.pos - start_real)
        if 0 <= mpac < n:
            tbl = sc.vcf_table.get(chrom)
            if tbl is not None and contig.pos in tbl:
                marker_id[mpac] = tbl[contig.pos]
        if chrom in ("X", "Y"):
            is_xy[contig.offset:contig.offset + contig.length] = True

    return SiteTables.from_numpy(
        site_idx, marker_id, np.concatenate([idx.text.astype(np.int32), [4]]),
        np.asarray(sites.dbsnp, dtype=bool), is_xy, contig_id,
        np.array([c.offset for c in idx.contigs], np.int32),
        np.array([c.length for c in idx.contigs], np.int32),
        int(sites.total), len(sc.vcf_rec_vec), device)
