"""Shard-state serialization + merge for multi-host scale-out.

The scaling model (BASELINE.md): FASTQ shards data-parallel across
hosts, replicated index, statistics merged before the final solve.  Every
StatCollector accumulator is a commutative sum, histogram, set union or
concatenation (reference src/StatCollector.h:70-119), so shards can run
completely independently (``fastquick align --shard_out``) and be merged
offline (``fastquick merge``) -- the process-level equivalent of the
in-mesh psum path in parallel/mesh.py, and the one that crosses hosts
without a shared JAX runtime.

Merge-order note: per-marker pileup base order follows shard order, not
global read order (the likelihood and all outputs are order-insensitive;
only the .Pileup column ordering can differ from a single-process run).

PCR duplicates: shards store their propPair start:end key lists; the
merge recomputes NumPCRDup = 2 * (total_keys - |union|) so cross-shard
duplicates are counted exactly like a single run would.
"""

from __future__ import annotations

import json

import numpy as np

from .collector import StatCollector


def save_shard(col: StatCollector, path: str, prop_pair_keys: bool = True
               ) -> None:
    """Serialize the accumulator state of one shard run."""
    col.flush_dense()
    d: dict = {}
    s = col.sites
    d["depth"] = s.depth
    d["q20"] = s.q20
    d["q30"] = s.q30
    for name in ("depth_dist", "cycle_dist", "gc_dist", "pos_num",
                 "emp_rep_dist", "mis_emp_rep_dist", "emp_cycle_dist",
                 "mis_emp_cycle_dist"):
        d[name] = np.asarray(getattr(col, name))
    d["insert_size_dist"] = np.asarray(col.insert_size_dist)
    # ragged per-marker pileups -> concatenated + offsets
    n_mk = len(col.seq_vec)
    lens = np.array([len(v) for v in col.qual_vec], dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)])
    d["pileup_offsets"] = offs
    d["pileup_seq"] = np.frombuffer(
        "".join(col.seq_vec).encode("ascii"), dtype=np.uint8)
    d["pileup_qual"] = np.array(
        [q for v in col.qual_vec for q in v], dtype=np.int32)
    d["pileup_cycle"] = np.array(
        [c for v in col.cycle_vec for c in v], dtype=np.int32)
    d["pileup_maq"] = np.array(
        [m for v in col.maq_vec for m in v], dtype=np.int32)
    d["pileup_strand"] = np.array(
        [s_ for v in col.strand_vec for s_ in v], dtype=bool)
    meta = {
        "dup_keys": sorted(col.duplicate_table),
        "num_pair_reads": col.num_pair_reads,
        "num_pcr_dup": col.num_pcr_dup,
        "contig_status": col.contig_status,
        "fsc": [vars(f) for f in col.fsc_vec],
    }
    d["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **d)


def merge_shards(col: StatCollector, shard_paths: list[str]) -> None:
    """Merge shard states into a freshly restored collector (which must
    have restore_vcf_sites + set_genome_size already applied)."""
    col.flush_dense()
    from .collector import FileStat

    s = col.sites
    total_keys = 0
    union: set[str] = set()
    for path in shard_paths:
        z = np.load(path, allow_pickle=False)
        s.depth += z["depth"]
        s.q20 += z["q20"]
        s.q30 += z["q30"]
        for name in ("depth_dist", "cycle_dist", "gc_dist", "pos_num",
                     "emp_rep_dist", "mis_emp_rep_dist", "emp_cycle_dist",
                     "mis_emp_cycle_dist"):
            getattr(col, name)[:] += z[name]
        col.insert_size_dist = [a + int(b) for a, b in
                                zip(col.insert_size_dist,
                                    z["insert_size_dist"])]
        offs = z["pileup_offsets"]
        seq = z["pileup_seq"].tobytes().decode("ascii")
        for m in range(len(offs) - 1):
            a, b = int(offs[m]), int(offs[m + 1])
            if a == b:
                continue
            col.seq_vec[m] += seq[a:b]
            col.qual_vec[m].extend(int(x) for x in z["pileup_qual"][a:b])
            col.cycle_vec[m].extend(int(x) for x in z["pileup_cycle"][a:b])
            col.maq_vec[m].extend(int(x) for x in z["pileup_maq"][a:b])
            col.strand_vec[m].extend(bool(x) for x in z["pileup_strand"][a:b])
        meta = json.loads(z["meta_json"].tobytes().decode())
        total_keys += len(meta["dup_keys"]) + meta["num_pcr_dup"] // 2
        union.update(meta["dup_keys"])
        for name, cs in meta["contig_status"].items():
            dst = col._contig_stat(name)
            for i in range(4):
                dst[i] += cs[i]
        for f in meta["fsc"]:
            col.fsc_vec.append(FileStat(**f))
    col.duplicate_table = union
    col.num_pair_reads = 2 * total_keys
    col.num_pcr_dup = 2 * (total_keys - len(union))
