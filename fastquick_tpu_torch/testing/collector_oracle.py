"""The product files that ``align --device_qc``'s collector writes for the
one-program step's placements, for the tests that hold the step's
EmpRepDist, EmpCycleDist and Pileup to the align path.

The step and ``align`` differ in what they place (the step has no mate
rescue, no gapped refine and its own mapping qualities), so the oracle
takes the step's own placements: each read the step counted (mapped,
mapQ >= 20, ungapped: its per-pair rows) goes, with the step's position,
strand and mapQ, through the align path's accounting as the driver hands
it a read after refine (the read as sequenced, an MD string from the
text, no CIGAR): ``KeyedStatCollector.add_single_alignment`` with
``DeviceDenseStats`` on the world's device for the dense sums, the
collector's own marker walk for the pileups, then ``process_core``.
"""

from __future__ import annotations

import copy

import numpy as np


def counted_rows(rows: dict, n_pairs: int) -> list[tuple[int, int, int, int]]:
    """(row, pos, strand, mapQ) of every read the step's accumulation
    counted, in row order (rows 2i, 2i + 1 are pair i's ends)."""
    out = []
    for i in range(n_pairs):
        for j in (0, 1):
            if (rows[f"mapped{j}"][i] and int(rows[f"mapq{j}"][i]) >= 20
                    and int(rows[f"n_gapo{j}"][i]) == 0
                    and int(rows[f"n_gape{j}"][i]) == 0):
                out.append((2 * i + j, int(rows[f"pos{j}"][i]),
                            int(rows[f"strand{j}"][i]),
                            int(rows[f"mapq{j}"][i])))
    return out


def align_products(prefix: str, rows: dict, world: dict) -> list[str]:
    """Write the align path's product files for the step's placements
    (``rows``, numpy) of ``world`` (qc_program.world_from_files) under
    ``prefix``; returns the written paths, sorted.  Only the dense and
    pileup files (DepthDist, EmpRepDist, EmpCycleDist, Pileup) are
    meaningful: no pair, insert size or file statistic is added."""
    import glob

    from ..align.core import BWA_TYPE_UNIQUE
    from ..align.device_qc import DeviceDenseStats
    from ..align.refine import bwa_cal_md1
    from ..align.sample_setup import sample_collector
    from ..stats.collector import FileStat

    idx, opt = world["idx"], world["opt"]
    coll = sample_collector(world["new_ref"], opt)
    coll.dense_device = DeviceDenseStats(idx, coll, opt, world["device"])
    for row, pos, strand, mapq in counted_rows(rows, world["n_pairs"]):
        p = copy.copy(world["reads"][row])
        fwd = p.forward_codes()
        p.seq = fwd.copy()  # refine leaves the read as sequenced
        oriented = fwd if strand == 0 else np.where(fwd < 4, 3 - fwd,
                                                    4)[::-1]
        p.md, p.nm = bwa_cal_md1(None, p.len, pos,
                                 np.ascontiguousarray(oriented, np.uint8),
                                 idx.text)
        p.pos, p.strand, p.mapQ = pos, strand, mapq
        p.type, p.cigar = BWA_TYPE_UNIQUE, None
        coll.add_single_alignment(idx, p, opt)
    coll.flush_dense()
    fsc = FileStat(file_name1=world["fname1"], file_name2=world["fname2"])
    fsc.num_read = 2 * world["n_pairs"]
    fsc.num_base = world["n_base"]
    coll.add_fsc(fsc)
    open(prefix + ".InsertSizeTable", "w").close()  # process_core reads it
    coll.process_core(prefix, opt)
    return sorted(glob.glob(prefix + ".*"))
