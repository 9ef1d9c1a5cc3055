"""A configuration's genome, marker VCFs and the port's index, from the
configuration's own seed.

The layout is a frozen copy of the port's production world
(``testing/synthworld.build_production_world``): a marker every
``spacing`` bp of a random genome of (markers + 2) x spacing bp, REF the
genome's base and ALT the next base in ACGT order, AF drawn from
U(af_low, af_high), dbSNP at every ``dbsnp_every``-th marker.  A lab's
reference and index are the same for every sample, so ``--seed`` plays no
part here.

``genome(world_cfg)`` is pure NumPy and is what the reference reads;
``ensure_index(cfg, cache)`` writes the FASTA and VCFs and runs the port's
``index`` command once into ``cache/<key>/``, where later runs find it.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import sys

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)


def genome(w: dict) -> dict:
    """codes (uint8 0..3, 0-based), marker positions (1-based), AFs and the
    dbSNP flag of each marker."""
    rng = np.random.default_rng(w["seed"])
    n = w["n_markers"]
    glen = (n + 2) * w["spacing"]
    codes = rng.integers(0, 4, glen).astype(np.uint8)
    afs = rng.uniform(w["af_low"], w["af_high"], n)
    pos = (np.arange(n, dtype=np.int64) + 1) * w["spacing"]
    return dict(codes=codes, pos=pos, af=np.round(afs, 3),
                ref=codes[pos - 1], alt=(codes[pos - 1] + 1) % 4,
                dbsnp=(np.arange(n) % w["dbsnp_every"]) == 0)


def _key(cfg: dict) -> str:
    blob = json.dumps([cfg["world"], cfg["index"]], sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def write_inputs(g: dict, out: str) -> dict:
    """g.fa, cand.vcf and dbsnp.vcf of genome `g` under `out`."""
    paths = {k: os.path.join(out, f) for k, f in
             (("ref", "g.fa"), ("cand", "cand.vcf"), ("dbsnp", "dbsnp.vcf"))}
    seq = ACGT[g["codes"]].tobytes()
    with open(paths["ref"], "wb") as fh:
        fh.write(b">1\n")
        fh.write(b"\n".join(seq[i:i + 60] for i in range(0, len(seq), 60)))
        fh.write(b"\n")
    head = ("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
            "FILTER\tINFO\n")
    ref = ACGT[g["ref"]].tobytes().decode()
    alt = ACGT[g["alt"]].tobytes().decode()
    with open(paths["cand"], "w") as fc, open(paths["dbsnp"], "w") as fd:
        fc.write(head)
        fd.write(head)
        for j, p in enumerate(g["pos"].tolist()):
            line = f"1\t{p}\trs{p}\t{ref[j]}\t{alt[j]}\t.\tPASS\t"
            fc.write(line + f"AF={g['af'][j]:.3f}\n")
            if g["dbsnp"][j]:
                fd.write(line + ".\n")
    return paths


def ensure_index(cfg: dict, cache: str) -> str:
    """The index prefix of cfg's world, built by the port's ``index``
    command into cache/<key>/ on first use (the build's log goes to
    standard error)."""
    final = os.path.join(cache, _key(cfg))
    prefix = os.path.join(final, "idx")
    if os.path.exists(os.path.join(final, "done")):
        return prefix
    shutil.rmtree(final, ignore_errors=True)  # a build that was cut
    os.makedirs(final)
    paths = write_inputs(genome(cfg["world"]), final)
    from fastquick_tpu_torch.cli import main

    ix = cfg["index"]
    with contextlib.redirect_stdout(sys.stderr):
        rc = main(["index", "--siteVCF", paths["cand"], "--dbsnpVCF",
                   paths["dbsnp"], "--ref", paths["ref"], "--out_prefix",
                   prefix, "--var_short", str(ix["var_short"]),
                   "--var_long", str(ix["var_long"]),
                   "--flank_len", str(ix["flank_len"]),
                   "--flank_long_len", str(ix["flank_long_len"])])
    if rc != 0:
        raise RuntimeError(f"index failed with {rc}")
    open(os.path.join(final, "done"), "w").close()
    return prefix

