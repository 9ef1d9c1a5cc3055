"""The repository's benchmark configs, run through the port's CLI.

Counterpart of the repository's tools/bench_configs.py.  Each config
prints one JSON line {"config", "metric", "value", "unit", ..., "device"}
and holds what it made to a second run:

- ``panel100k``: ``align --device_qc`` and ``align --engine native`` on
  testing/synthworld.build_production_world at 50,000 pairs (the root
  config's, on the port's copy of tools/stress_production_scale.py's
  world): both engines' reads/s, the exact redo's share, the phase times;
  the 12 product files of the two runs byte-identical;
- ``sample1m``: the same at 500,000 pairs (1,000,000 reads);
- ``wgs_stream`` (2 shards) and ``multisample`` (4 shards): the FASTQs
  split by record stride, ``align --device_qc --shard_out`` on each shard
  and ``merge``, timed; then the same with the native engine, the shard
  BAMs and the 11 merged files byte-identical.  The root configs run on
  the reference's bundled example; these run on build_synth_pe_world
  (``"world": "synth_pe"``);
- ``program200k``: qc_program.run_with_fill over the production world's
  200,000 reads as one batch (the one-program step), at qc_full's
  defaults (resident kernel: pool 256, chain 4, step cap 64 L) and with
  the scan kernel (chain 1, pool 512, cap 768), the exact redo by the
  card's retry and the native engine: every accumulator, row and product
  file of the two runs identical.  The world's load is reported apart and
  not counted;
- ``example``: the bundled example's index, align and pop+con; it needs
  the reference tree's ``example/`` and ``resource/`` under
  ``$FQ_REFERENCE`` and raises FileNotFoundError without them.

    python -m fastquick_tpu_torch.bench_configs [--device cuda|cpu] \\
        [names ...]        # default: wgs_stream multisample

Every align runs with ``--device`` (cuda unless asked for the CPU); the
kernels are built before the first config, off the clock; every
host-clock interval ends in a synchronise of the card.  A config that
fails is printed with its error, and the run then exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import filecmp
import gzip
import json
import os
import shutil
import sys
import tempfile
import time
from functools import partial

import torch

from .bench import device_info, sync
from .utils.device import resolve_device

# the 12 product files of an align run (tests/test_device_qc.py's
# ALL_OUTPUTS); merge writes all but the BAM
PRODUCTS = ("Summary", "DepthDist", "GCDist", "EmpRepDist", "EmpCycleDist",
            "RawInsertSizeDist", "AdjustedInsertSizeDist", "SexChromInfo",
            "Pileup", "vcf", "InsertSizeTable", "bam")
# the one-program batch's padded read length; qc_step_full's defaults
# (step cap 64 L) and the scan kernel's settings
PROGRAM_L = 160
PROGRAM_RUNS = (
    ("resident", dict(pool=256, chain=4, step_cap=64 * PROGRAM_L)),
    ("scan", dict(pool=512, chain=1, step_cap=768)))


def same_products(a: str, b: str, sfxs=PRODUCTS) -> None:
    """Raise unless the product files <a>.<sfx> and <b>.<sfx> are
    byte-identical."""
    for sfx in sfxs:
        if not filecmp.cmp(f"{a}.{sfx}", f"{b}.{sfx}", shallow=False):
            raise AssertionError(f".{sfx} differs: {a} vs {b}")


def cli(argv: list[str], dev: torch.device) -> float:
    """The port's CLI on argv (its log to stderr); seconds, the card
    synchronised before each clock read."""
    from .cli import main

    sync(dev)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        rc = main(argv)
    sync(dev)
    if rc != 0:
        raise RuntimeError(f"{' '.join(argv[:1])} exited {rc}")
    return time.perf_counter() - t0


def align(argv: list[str], dev: torch.device) -> dict:
    """One align run: its wall seconds and align's LAST_RUN_STATS."""
    from .align import driver

    wall = cli(["align"] + argv + ["--device", str(dev.type)], dev)
    return dict(driver.LAST_RUN_STATS, wall_s=wall)


def _phases(st: dict) -> dict:
    return {k: round(v, 3) for k, v in st["stage_t"].items()}


def panel(n_pairs: int, name: str, dev: torch.device, tmp: str,
          **world_kw) -> dict:
    """align --device_qc against --engine native on the production world
    of n_pairs pairs."""
    from .testing.synthworld import build_production_world

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        w = build_production_world(tmp, n_pairs=n_pairs, **world_kw)
    world_s = time.perf_counter() - t0
    common = ["--fastq_1", w["fq1"], "--fastq_2", w["fq2"],
              "--index_prefix", w["idx_prefix"]]
    dev_st = align(common + ["--out_prefix", f"{tmp}/dev", "--device_qc"],
                   dev)
    nat_st = align(common + ["--out_prefix", f"{tmp}/nat", "--engine",
                             "native"], dev)
    same_products(f"{tmp}/nat", f"{tmp}/dev")
    n = w["n_reads"]
    return {"config": name, "metric": "align_reads_per_sec_e2e",
            "value": round(n / dev_st["wall_s"], 1), "unit": "reads/s",
            "native_reads_per_sec": round(n / nat_st["wall_s"], 1),
            "reads": n, "device_wall_s": round(dev_st["wall_s"], 3),
            "native_wall_s": round(nat_st["wall_s"], 3),
            "redo_share": dev_st["fallback"] / max(dev_st["searched"], 1),
            "fallback_causes": dev_st["fb_causes"],
            "search_kernel": dev_st["search_kernel"],
            "phases": _phases(dev_st), "native_phases": _phases(nat_st),
            "files_identical": len(PRODUCTS), "world_s": round(world_s, 1)}


def split_fastq(src: str, n: int, pattern: str) -> int:
    """Split a gzip FASTQ into n shards by record stride (record i to
    shard i % n), written to pattern.format(s); returns the records."""
    with gzip.open(src, "rt") as fh:
        lines = fh.read().splitlines()
    recs = [lines[i:i + 4] for i in range(0, len(lines), 4)]
    for s in range(n):
        with gzip.open(pattern.format(s), "wt", compresslevel=1) as fh:
            for r in recs[s::n]:
                fh.write("\n".join(r) + "\n")
    return len(recs)


def sharded(n_shards: int, name: str, dev: torch.device, tmp: str,
            **world_kw) -> dict:
    """n_shards shards of the synthetic PE world aligned on the device
    path with --shard_out and merged (timed), then by the native engine,
    the shard BAMs and merged files byte-identical."""
    from .testing.synthworld import build_synth_pe_world

    with contextlib.redirect_stdout(sys.stderr):
        w = build_synth_pe_world(tmp, **world_kw)
    n_recs = 0
    for j, fq in ((1, w["fq1"]), (2, w["fq2"])):
        n_recs += split_fastq(fq, n_shards, f"{tmp}/shard{{}}_{j}.fq.gz")
    walls = {}
    for eng, flags in (("dev", ["--device_qc"]),
                       ("nat", ["--engine", "native"])):
        sync(dev)
        t0 = time.perf_counter()
        for s in range(n_shards):
            align(["--fastq_1", f"{tmp}/shard{s}_1.fq.gz", "--fastq_2",
                   f"{tmp}/shard{s}_2.fq.gz", "--index_prefix",
                   w["idx_prefix"], "--out_prefix", f"{tmp}/{eng}{s}",
                   "--shard_out"] + flags, dev)
        cli(["merge", "--index_prefix", w["idx_prefix"], "--out_prefix",
             f"{tmp}/{eng}_merged"]
            + [f"{tmp}/{eng}{s}" for s in range(n_shards)], dev)
        walls[eng] = time.perf_counter() - t0
    for s in range(n_shards):
        same_products(f"{tmp}/nat{s}", f"{tmp}/dev{s}", ("bam",))
    same_products(f"{tmp}/nat_merged", f"{tmp}/dev_merged", PRODUCTS[:-1])
    return {"config": name, "metric": "sharded_align_merge_wall",
            "value": round(walls["dev"], 3), "unit": "s",
            "n_shards": n_shards, "world": "synth_pe", "reads": n_recs,
            "native_wall_s": round(walls["nat"], 3),
            "files_identical": len(PRODUCTS) - 1 + n_shards}


def program(dev: torch.device, tmp: str, n_pairs: int = 100_000,
            **world_kw) -> dict:
    """run_with_fill over the production world's reads as one batch,
    resident at qc_full's defaults and scan, identical in every
    accumulator, row and product file."""
    from . import qc_program as qp
    from .align.engine import NativeEngine
    from .kernels import build
    from .testing.synthworld import build_production_world

    with contextlib.redirect_stdout(sys.stderr):
        w = build_production_world(tmp, n_pairs=n_pairs, **world_kw)
    sync(dev)
    t0 = time.perf_counter()
    world = qp.world_from_files(tmp, w["idx_prefix"], w["fq1"], w["fq2"],
                                "r_1.fq", "r_2.fq", device=dev,
                                L=PROGRAM_L, bitmaps=True)
    sync(dev)
    load_s = time.perf_counter() - t0
    n = 2 * world["n_pairs"]
    engine = NativeEngine(world["idx"])
    out = {"config": "program200k", "metric": "qc_reads_per_sec",
           "unit": "reads/s", "reads": n, "load_s": round(load_s, 3)}
    runs = {}
    for name, opts in PROGRAM_RUNS:
        world["opt_args"].update(opts)
        build.reset_launch_counts()
        times: dict = {}
        sync(dev)
        t0 = time.perf_counter()
        stats, rows, fb1 = qp.run_with_fill(world, engine=engine,
                                            kernel=name, times=times)
        sync(dev)
        wall = time.perf_counter() - t0
        if int(stats["n_fallback"]):
            raise AssertionError(f"program200k {name}: fallback reads left "
                                 "after the fill pass")
        with contextlib.redirect_stdout(sys.stderr):
            files = qp.write_product(f"{tmp}/{name}", stats, rows,
                                     world["names"], world)
        runs[name] = ((stats, rows), files)
        fill_s = sum(v for k, v in times.items()
                     if k not in ("first_pass", "host_redo"))
        out[name] = {"reads_per_sec": round(n / wall, 1),
                     "wall_s": round(wall, 4),
                     "first_pass_s": round(times["first_pass"], 4),
                     "first_pass_fallback": fb1,
                     "host_redo_s": round(times["host_redo"], 4),
                     "fill_pass_s": round(fill_s, 4),
                     "fill_reads_per_sec": round(n / fill_s, 1),
                     "times": {k: round(v, 4) for k, v in times.items()},
                     "launches": {k: v for k, v in build.launch_counts.items()
                                  if v},
                     "opts": opts}
    qp.same_run(runs["resident"][0], runs["scan"][0],
                "program200k, resident vs scan")
    out["files_identical"] = qp.same_files(runs["resident"][1],
                                           runs["scan"][1],
                                           "program200k, resident vs scan")
    out["value"] = out["resident"]["reads_per_sec"]
    return out


def example(dev: torch.device, tmp: str) -> dict:
    """The bundled example's pipeline (index, align, pop+con), timed."""
    import glob

    root = os.environ.get("FQ_REFERENCE", "")
    ex, res = os.path.join(root, "example"), os.path.join(root, "resource")
    if not (root and os.path.isdir(ex) and os.path.isdir(res)):
        raise FileNotFoundError(
            f"example needs the reference tree's example/ and resource/ "
            f"directories under $FQ_REFERENCE (now {root!r})")
    for f in glob.glob(ex + "/*.fastq.gz") + [ex + "/fq.test.list"]:
        shutil.copy(f, tmp)
    cwd = os.getcwd()
    os.chdir(tmp)  # fq.test.list names the FASTQs relative to it
    try:
        sync(dev)
        t0 = time.perf_counter()
        cli(["index", "--siteVCF", ex + "/hapmap.test.vcf.gz", "--dbsnpVCF",
             ex + "/dbsnp.test.vcf.gz", "--ref", ex + "/ref.test.fa",
             "--out_prefix", "idx"], dev)
        align(["--fq_list", "fq.test.list", "--index_prefix", "idx",
               "--out_prefix", "out"], dev)
        cli(["pop+con", "--DisableSanityCheck", "--PileupFile", "out.Pileup",
             "--SVDPrefix", res + "/hapmap_3.3.b37.dat", "--Output", "out"],
            dev)
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    return {"config": "example", "metric": "pipeline_wall",
            "value": round(wall, 3), "unit": "s"}


CONFIGS = {
    "example": example,
    "panel100k": partial(panel, 50_000, "panel100k"),
    "sample1m": partial(panel, 500_000, "sample1m"),
    "wgs_stream": partial(sharded, 2, "wgs_stream"),
    "multisample": partial(sharded, 4, "multisample"),
    "program200k": program,
}


def run(name: str, dev: torch.device, **world_kw) -> dict:
    """One config in a temporary directory; returns its JSON line.
    world_kw goes to the world's build function (smaller worlds for
    tests).  On the card the kernels are built (or loaded) first, off the
    clock: their time is the line's kernel_build_s (0 once this process
    has them)."""
    build_s = None
    if dev.type == "cuda":
        from .kernels import build

        t0 = time.perf_counter()
        build.cuda_library()
        build_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix=f"fq_cfg_{name}_")
    try:
        out = CONFIGS[name](dev, tmp, **world_kw)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if build_s is not None:
        out["kernel_build_s"] = round(build_s, 3)
    out["device"] = device_info(dev)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", default=["wgs_stream", "multisample"],
                    help=" ".join(CONFIGS))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    unknown = [n for n in args.names if n not in CONFIGS]
    if unknown:
        raise ValueError(f"unknown configs {unknown}: {' '.join(CONFIGS)}")
    dev = resolve_device(args.device)
    failed = False
    for name in args.names:
        try:
            line = run(name, dev)
        except Exception as e:  # reported on its line; the next one runs
            line = {"config": name, "error": f"{type(e).__name__}: {e}"[:300]}
            failed = True
        print(json.dumps(line), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
