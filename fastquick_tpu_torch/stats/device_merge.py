"""Merge device QC accumulators (ops/qc_full) into a StatCollector.

The device full-QC step returns the complete accumulator set as integer
tensors (psum-merged across the mesh).  This module is the SOLVE side:
it populates a host StatCollector so the standard 14-output writers
(collector.process_core) produce the report files -- one merge, one
solve, however many chips produced the tensors.

Field mapping (device -> StatCollector / reference struct):
  depth/q20/q30      -> sites.depth/q20/q30  (StatCollector.h DepthVec,
                        Q20DepthVec, Q30DepthVec over the dense space)
  emp_rep/mis_*      -> EmpRepDist / misEmpRepDist
  emp_cycle/mis_*    -> EmpCycleDist / misEmpCycleDist
  pileup(+cnt)       -> seqVec/qualVec/cycleVec/maqVec/strandVec
  n_xy               -> contig_status-style X/Y read counting
"""

from __future__ import annotations

import numpy as np

from ..ops.qc_full import unpack_entry

_BASES = "ACGTN"


def populate_from_device(sc, acc: dict) -> None:
    """Add one device accumulator set into StatCollector `sc`.

    `sc` must have run restore_vcf_sites (so the dense site table and
    the per-marker vectors exist).  Safe to call repeatedly (adds)."""
    sites = sc.sites
    depth = np.asarray(acc["depth"], np.int64)
    q20 = np.asarray(acc["q20"], np.int64)
    q30 = np.asarray(acc["q30"], np.int64)
    if len(depth) != sites.total:
        raise ValueError(
            f"device dense space {len(depth)} != collector {sites.total}")
    sites.depth += depth
    sites.q20 += q20
    sites.q30 += q30
    sc.emp_rep_dist += np.asarray(acc["emp_rep"], np.int64)
    sc.mis_emp_rep_dist += np.asarray(acc["mis_emp_rep"], np.int64)
    sc.emp_cycle_dist += np.asarray(acc["emp_cycle"], np.int64)
    sc.mis_emp_cycle_dist += np.asarray(acc["mis_emp_cycle"], np.int64)

    pu = np.asarray(acc["pileup"])
    cnt = np.asarray(acc["pileup_cnt"])
    M, cap = pu.shape
    for m in range(M):
        k = int(min(cnt[m], cap))
        if k == 0:
            continue
        base, qual, mapq, strand, cycle = unpack_entry(pu[m, :k])
        sc.seq_vec[m] += "".join(_BASES[b] for b in base)
        sc.qual_vec[m].extend(int(q) for q in qual)
        sc.cycle_vec[m].extend(int(c) for c in cycle)
        sc.maq_vec[m].extend(int(q) + 33 for q in mapq)
        sc.strand_vec[m].extend(bool(s) for s in strand)
