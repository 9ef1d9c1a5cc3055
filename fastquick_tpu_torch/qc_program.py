"""The one-program QC step (ops/qc_full.qc_step_full) on one device or over
a mesh of ranks: worlds, runs and the product files.

Counterpart of the reference's ``__graft_entry__.py``: ``entry`` is its
compile-check entry, ``world_from_files`` / ``run_single`` /
``write_product`` its dry run's world, step and writers, with ``device``
chosen by the caller (cuda by default; "cpu" runs every kernel's plain
version), and ``mesh_stats`` / ``diff_world`` / ``dryrun_multichip`` its
mesh half (``_mesh_stats``, ``_diff_world``, ``dryrun_multichip``): each
rank runs its block of the rows through parallel/mesh.
make_sharded_qc_full_step.  ``run_with_fill`` is the two-dispatch recipe
that makes the drand48 stream exact on a batch with fallback reads: run
once, redo the fallback reads (the pool overflows searched again on the
card at a deeper slab, the rest by the exact native, else host, engine),
pack their hit lists and run again with them filled in (on a mesh, each
rank redoes its own rows).

    from fastquick_tpu_torch import qc_program as qp
    world = qp.world_from_files(tmp, idx_prefix, fq1, fq2, "a_1.fq",
                                "a_2.fq", device="cpu")
    stats, rows = qp.run_single(world)
    qp.write_product(prefix, stats, rows, world["names"], world)

Over two gloo ranks on the CPU (every rank loads the world and runs its
rows; rank 0 writes the files):

    from fastquick_tpu_torch.parallel.mesh import spawn
    spec = dict(tmp=tmp, idx_prefix=idx_prefix, fq1=fq1, fq2=fq2,
                device="cpu", out_dir=out, runs=[dict(name="a",
                kernel="resident", fill=True)])
    results = spawn(qp.mesh_job, 2, (spec,))
"""

from __future__ import annotations

import contextlib
import glob
import time

import numpy as np
import torch

from .align.opts import GapOpt, PeOpt, bwa_cal_maxdiff
from .align.sample_setup import index_options, sample_collector
from .ops import host_redo
from .ops.qc_full import (
    build_site_tables,
    count_pcr_dups,
    qc_step_full,
    synthetic_site_tables,
)
from .parallel.mesh import local_rows, make_sharded_qc_full_step
from .utils import spans
from .utils.device import resolve_device

_STATUS = ["PropPair", "PartialPair", "FwdOnly", "RevOnly", "NotPair",
           "LowQual"]

# The last run_with_fill call (this rank's, on a mesh): "stage_t" the
# seconds of every span of the call (utils/spans.py: ``program``, its
# phases ``program.first_pass``, ``program.host_redo``,
# ``program.fill_pass`` and the step's stages inside the passes, summed
# over both; inside ``program.host_redo``, ``program.host_redo.card`` the
# retry of the pool overflows on the card and ``program.host_redo.native``
# the native engine's search), "counts" the batch's rows searched,
# first-pass fallback rows, the rows that entered the card's retry
# (``card_retry_rows``), the rows it finished (``card_retry_done``), its
# launches (``card_retry_launches``), the rows the redo's exact engine took
# (``redo_rows``) and, of them, the rows its Python oracle took
# (``redo_oracle_rows``) and, when the call was given `times`, each pass's
# work
# (``first_pass``, ``fill_pass``: qc_step_full's counts, read back once).
LAST_RUN_STATS: dict = {}


def tiny_index(n: int = 16384, seed: int = 0, device="cuda"):
    """A random text of n bases and its DeviceFM on `device`."""
    from .index.fmindex import FMIndex
    from .ops.fm import DeviceFM

    rng = np.random.default_rng(seed)
    text = rng.integers(0, 4, n).astype(np.uint8)
    fm_f = FMIndex.build(text)
    fm_r = FMIndex.build(text[::-1].copy())
    return text, DeviceFM.build(fm_f, fm_r, resolve_device(device))


def make_reads(text, n_reads, read_len, seed=1, ragged=False):
    """(seqs, rseqs, lens, quals) numpy arrays of reads drawn from text:
    reversed codes, their reverse complements, lengths and qualities;
    every fourth read carries one mismatch."""
    rng = np.random.default_rng(seed)
    B = n_reads
    L = read_len
    seqs = np.full((B, L), 4, dtype=np.int32)  # reversed codes
    rseqs = np.full((B, L), 4, dtype=np.int32)  # revcomp codes
    quals = np.zeros((B, L), dtype=np.int32)
    lens = np.zeros(B, dtype=np.int32)
    for b in range(B):
        ln = int(rng.integers(40, L + 1)) if ragged else L
        start = int(rng.integers(0, len(text) - ln))
        codes = text[start:start + ln].astype(np.int32)
        if b % 4 == 1:
            p = int(rng.integers(0, ln))
            codes[p] = (codes[p] + 1) % 4
        seqs[b, :ln] = codes[::-1]
        rseqs[b, :ln] = (3 - codes)[::-1]
        quals[b, :ln] = rng.integers(20, 40, ln)
        lens[b] = ln
    return seqs, rseqs, lens, quals


def full_world(read_len: int = 76, device="cuda"):
    """(text, DeviceFM, SiteTables, opt_args, md_table) over tiny_index."""
    text, dev = tiny_index(device=device)
    tables = synthetic_site_tables(text, device=dev.device)
    opt_args = {"n_text": dev.n, "max_diff": 4, "use_seed": True,
                "pool": 256, "inner": 16, "step_cap": 64 * read_len}
    opt = GapOpt()
    md_table = torch.tensor([bwa_cal_maxdiff(i, thres=opt.fnr)
                             for i in range(read_len + 1)],
                            dtype=torch.int32, device=dev.device)
    return text, dev, tables, opt_args, md_table


def entry(device="cuda"):
    """(fn, example_args): the single-device QC step over 64 reads of 76
    bp -- inexact FM search, SE selection + mapQ, SA positions and the
    complete accumulator set (ops/qc_full.qc_step_full)."""
    text, dev, tables, opt_args, md_table = full_world(device=device)
    seqs, rseqs, lens, quals = make_reads(text, 64, 76)

    def fn(seqs, rseqs, quals, lens):
        return qc_step_full(dev, tables, opt_args, seqs, rseqs, quals, lens,
                            md_table=md_table)

    example_args = tuple(torch.from_numpy(a).to(dev.device)
                         for a in (seqs, rseqs, quals, lens))
    return fn, example_args


def world_from_files(tmp, idx_prefix, fq1, fq2, fname1, fname2,
                     device="cuda", L: int = 256, bitmaps: bool = False):
    """Load an index + PE FASTQs into interleaved batch tensors on
    `device` (rows 2i, 2i+1 are pair i's ends; rows the host k-mer filter
    dropped stay all-N, so unmapped).  L: the padded read length.
    bitmaps: also upload the k-mer filter's bitmaps (6 x 512 MiB), which
    run_single then applies on the device.  The returned dict keeps the
    reads (``reads``, in row order) and their host planes (``host_rows``)
    for run_with_fill's host redo."""
    from .align.seqs import FastqReader, read_batch
    from .index.builder import load_index
    from .ops.fm import DeviceFM
    from .ops.kmer import load_kmer_bitmaps

    dev_t = resolve_device(device)
    new_ref, opt, _ = index_options(idx_prefix)
    popt = PeOpt()
    idx = load_index(new_ref)
    collector = sample_collector(new_ref, opt)
    tables = build_site_tables(idx, collector, opt, dev_t)
    fm = DeviceFM.build(idx.fm_fwd, idx.fm_rev, dev_t)

    batches = []
    for path in (fq1, fq2):
        r = FastqReader(path)
        batches.append(read_batch(r, idx.kmer, 10 ** 6, opt.mode, 0,
                                  1.0, 0))
        r.close()
    b0, b1 = batches
    assert len(b0) == len(b1)
    B = 2 * len(b0)
    seqs = np.full((B, L), 4, np.int32)
    rseqs = np.full((B, L), 4, np.int32)
    quals = np.zeros((B, L), np.int32)
    lens = np.zeros(B, np.int32)
    names, reads = [], []
    for i in range(len(b0)):
        for j, p in enumerate((b0[i], b1[i])):
            row = 2 * i + j
            lens[row] = p.len
            if not p.filtered:  # filtered rows stay all-N => unmapped
                seqs[row, :p.len] = p.seq[:p.len]
                rseqs[row, :p.len] = p.rseq[:p.len]
                quals[row, :p.len] = p.qual[:p.len].astype(np.int32) - 33
            reads.append(p)
        names.append(b0[i].name)
    md_np = np.array([bwa_cal_maxdiff(i, thres=opt.fnr)
                      for i in range(L + 1)], np.int32)
    opt_args = {"n_text": fm.n, "max_diff": int(md_np.max()),
                "use_seed": True, "pool": 512, "inner": 16,
                "step_cap": 64 * L, "max_gapo": opt.max_gapo,
                "max_gape": opt.max_gape, "max_top2": opt.max_top2,
                "seed_len": opt.seed_len,
                "max_seed_diff": opt.max_seed_diff,
                "ap_prior": popt.ap_prior, "max_isize": popt.max_isize,
                "k_occ": 32, "s_mm": opt.s_mm,
                # the reference's drand48 reservoir selection on the device
                "drand48": True}
    arrays = tuple(torch.from_numpy(a).to(dev_t)
                   for a in (seqs, rseqs, quals, lens))
    # the host redo's copy of the planes (ops/host_redo.host_rows)
    host_rows = dict(reads=reads, planes=np.stack([seqs, rseqs], 1).astype(
        np.uint8), lens=lens, filtered=np.array([p.filtered for p in reads]))
    world = dict(tmp=tmp, idx=idx, opt=opt, new_ref=new_ref, tables=tables,
                 fm=fm, opt_args=opt_args,
                 md_table=torch.from_numpy(md_np).to(dev_t), arrays=arrays,
                 names=names, reads=reads, host_rows=host_rows,
                 n_pairs=len(b0), n_base=sum(p.full_len for p in b0 + b1),
                 fname1=fname1, fname2=fname2, device=dev_t)
    if bitmaps:
        world["bitmaps"] = load_kmer_bitmaps(idx.kmer.byte_bitmaps(), dev_t)
        world["thresh"] = idx.kmer.thresh
    return world


def write_product(prefix, acc, rows, names, world) -> list[str]:
    """Merge one run's device state into a fresh StatCollector and write
    the product files (the same writers the align stage uses); the
    .InsertSizeTable rows are rendered from the per-pair fields.  Returns
    the written paths, sorted."""
    from .stats.collector import FileStat
    from .stats.device_merge import populate_from_device

    idx, opt = world["idx"], world["opt"]
    collector = sample_collector(world["new_ref"], opt)
    acc = {k: _numpy(v) for k, v in acc.items() if not k.startswith("_")}
    populate_from_device(collector, acc)
    collector.insert_size_dist = [int(x) for x in acc["isize_dist"]]
    collector.num_pcr_dup = int(acc["n_pcr_dup"])
    collector.num_pair_reads = int(acc["n_pair_reads"])
    fsc = FileStat(file_name1=world["fname1"], file_name2=world["fname2"])
    fsc.num_read = 2 * world["n_pairs"]
    fsc.num_base = world["n_base"]
    fsc.total_retained = int(acc["n_mapped"])
    collector.add_fsc(fsc)

    r = {k: _numpy(v) for k, v in rows.items()}
    cnames = [c.name for c in idx.contigs]
    coffs = np.asarray([c.offset for c in idx.contigs])
    with open(prefix + ".InsertSizeTable", "w") as fout:
        for i in range(world["n_pairs"]):
            st = int(r["status"][i])
            if st < 0:
                continue
            m0, m1 = bool(r["mapped0"][i]), bool(r["mapped1"][i])

            def side(j):
                if not (r[f"mapped{j}"][i]):
                    return ("*", "*", 0, "*")
                cid = int(r["cid_p"][i] if j == 0 else r["cid_q"][i])
                pos = int(r[f"pos{j}"][i]) - int(coffs[cid]) + 1
                ln = int(r[f"len{j}"][i])
                return (cnames[cid], str(pos), ln, f"{ln}M")

            c0, p0, l0, g0 = side(0)
            c1, p1, l1, g1 = side(1)
            f1 = 0x41 | (0x4 if not m0 else 0) \
                | (0x10 if int(r["strand0"][i]) else 0) \
                | (0x2 if bool(r["proper"][i]) else 0)
            f2 = 0x81 | (0x4 if not m1 else 0) \
                | (0x10 if int(r["strand1"][i]) else 0) \
                | (0x2 if bool(r["proper"][i]) else 0)
            fout.write(
                f"{names[i]}\t{int(r['mi'][i])}\t{int(r['mi2'][i])}\t"
                f"{int(r['actual'][i])}\t{c0}\t{p0}\t{f1}\t{l0}\t{g0}\t"
                f"{c1}\t{p1}\t{f2}\t{l1}\t{g1}\t{_STATUS[st]}\n")
    collector.process_core(prefix, opt)
    return sorted(glob.glob(prefix + ".*"))


def _numpy(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def run_single(world, pileup_cap: int = 64, kernel: str = "resident",
               times: dict | None = None, fb_fill=None, pe_fill=None,
               per_read: bool = False, counts: dict | None = None):
    """The whole batch as one pair-mode step on the world's device
    (times, counts: qc_step_full's).  Returns (stats, rows[, per_read]):
    the accumulators with n_pcr_dup (tensors on the device) and the
    per-pair rows as numpy arrays."""
    seqs, rseqs, quals, lens = world["arrays"]
    out = qc_step_full(world["fm"], world["tables"], world["opt_args"],
                       seqs, rseqs, quals, lens,
                       bitmaps=world.get("bitmaps"),
                       thresh=world.get("thresh", 3),
                       md_table=world["md_table"], pair_mode=True,
                       pileup_cap=pileup_cap, kernel=kernel, times=times,
                       fb_fill=fb_fill, pe_fill=pe_fill,
                       return_per_read=per_read, counts=counts)
    stats, pr = out if per_read else (out, None)
    stats["n_pcr_dup"] = count_pcr_dups(stats.pop("_pair_keys"))
    rows = {k: v.cpu().numpy() for k, v in stats.pop("_pair_rows").items()}
    return (stats, rows, pr) if per_read else (stats, rows)


def _shard(world, mesh):
    """(B, start, rows) of this rank's block of the world's B rows, padded
    at the end of the batch to a multiple of 2 * mesh.size so that no pair
    straddles two ranks (the padding lands in the last ranks)."""
    B = world["arrays"][0].shape[0]
    if mesh is None:
        return B, 0, B
    return (B, *local_rows(mesh, B + (-B) % (2 * mesh.size)))


def mesh_stats(world, mesh=None, pileup_cap: int = 64,
               kernel: str = "resident", times: dict | None = None,
               fb_fill=None, per_read: bool = False,
               counts: dict | None = None):
    """The world's batch as one pair-mode step: run_single when mesh is
    None, else over the mesh's ranks (parallel/mesh.
    make_sharded_qc_full_step), this rank running its block of the rows
    (_shard; padding rows are all-N with length 0).  fb_fill: this rank's
    rows' fill; counts: this rank's step's.  Returns (stats, rows[,
    per_read]) as run_single does: the
    merged accumulators with n_pcr_dup, the per-pair rows of the B // 2
    real pairs, and this rank's per-read flags."""
    if mesh is None:
        return run_single(world, pileup_cap, kernel, times, fb_fill,
                          per_read=per_read, counts=counts)
    B, lo, nb = _shard(world, mesh)

    def local(a, fill):
        part = a[lo: min(lo + nb, B)]
        pad = nb - part.shape[0]
        return torch.cat([part, part.new_full((pad,) + tuple(a.shape[1:]),
                                              fill)]) if pad else part

    seqs, rseqs, quals, lens = world["arrays"]
    step = make_sharded_qc_full_step(
        mesh, world["fm"], world["tables"], world["opt_args"],
        bitmaps=world.get("bitmaps"), thresh=world.get("thresh", 3),
        pileup_cap=pileup_cap, axis=mesh.axis_names,
        md_table=world["md_table"], pair_mode=True, kernel=kernel)
    out = step(local(seqs, 4), local(rseqs, 4), local(quals, 0),
               local(lens, 0), fb_fill=fb_fill, times=times,
               return_per_read=per_read, counts=counts)
    stats, pr = out if per_read else (out, None)
    rows = {k: v[: B // 2].cpu().numpy()
            for k, v in stats.pop("_pair_rows").items()}
    return (stats, rows, pr) if per_read else (stats, rows)


def run_with_fill(world, engine=None, pileup_cap: int = 64,
                  kernel: str = "resident", times: dict | None = None,
                  mesh=None):
    """The two-dispatch recipe: run the step once, redo its fallback reads
    (ops/host_redo.fill: the pool overflows searched again on the card at
    deeper slabs, the rest by `engine`, sample_setup.exact_engine by
    default), pack their hit lists (as arrays for a NativeEngine, through
    Read objects for another engine) and run again with them as fb_fill,
    so every read
    carries exact hits and the drand48 stream consumes them in read
    order.  On a mesh each rank redoes the fallback reads of its own rows
    and the second pass takes each rank's fill.  Returns (stats, rows, the first pass's
    fallback count).  times: the second pass's stages plus "first_pass"
    and "host_redo" (seconds; this rank's); given, the passes' counters
    are also read (LAST_RUN_STATS).  Each call runs in a span tally of its
    own, published in LAST_RUN_STATS."""
    dev = world["device"]
    B, lo, _ = _shard(world, mesh)
    work = None if times is None else {"first_pass": {}, "fill_pass": {}}
    with spans.call("program") as tally:
        t0 = time.perf_counter()
        with spans.span("program.first_pass"):
            first, _, pr = mesh_stats(
                world, mesh, pileup_cap, kernel, per_read=True,
                counts=None if work is None else work["first_pass"])
            fb = pr["fallback"].cpu().numpy()
            n_reads, n_filtered, n_fb = torch.stack(
                [first[k] for k in ("n_reads", "n_filtered",
                                    "n_fallback")]).tolist()
        t1 = time.perf_counter()
        with spans.span("program.host_redo"):
            fill, redo = host_redo.fill(world, engine, fb, lo, B, dev)
        t2 = time.perf_counter()
        with spans.span("program.fill_pass"):
            stats, rows = mesh_stats(
                world, mesh, pileup_cap, kernel, times=times, fb_fill=fill,
                counts=None if work is None else work["fill_pass"])
    if times is not None:
        times["first_pass"] = t1 - t0
        times["host_redo"] = t2 - t1
    counts = dict(rows_searched=n_reads - n_filtered,
                  first_pass_fallback=n_fb, **redo)
    if work is not None:
        counts.update(_read_back(work))
    LAST_RUN_STATS.clear()
    LAST_RUN_STATS.update(stage_t=tally.seconds(), counts=counts)
    return stats, rows, n_fb


def _read_back(tree):
    """tree (dicts and lists) with its device scalars read to the host in
    one copy: ints, or floats where the scalar is."""
    found: list = []

    def collect(x):
        if isinstance(x, dict):
            x = list(x.values())
        if isinstance(x, list):
            for v in x:
                collect(v)
        elif isinstance(x, torch.Tensor):
            found.append(x)

    def build(x, vals):
        if isinstance(x, dict):
            return {k: build(v, vals) for k, v in x.items()}
        if isinstance(x, list):
            return [build(v, vals) for v in x]
        if isinstance(x, torch.Tensor):
            v = next(vals)
            return v if x.is_floating_point() else int(v)
        return x

    collect(tree)
    vals = torch.stack([t.double().reshape(()) for t in found]).tolist() \
        if found else []
    return build(tree, iter(vals))


def _host(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else v


def build_native() -> None:
    """Build the native FASTQ loader, aligner and DP libraries in this
    process, so that ranks started after it load them: their builds write
    the library in place, and two ranks building at once could load a
    half-written one."""
    from .native import get_aligner_lib, get_lib, get_sw_lib

    get_lib()
    get_aligner_lib()
    get_sw_lib()


def mesh_job(mesh, spec: dict) -> dict:
    """One rank's runs of a world from files, for parallel/mesh.spawn (mesh
    None: one device, in this process).  spec: the world's files (tmp,
    idx_prefix, fq1, fq2), device, L, bitmaps, pileup_cap, out_dir (rank
    0 writes each run's product files there, prefixed by its name),
    engine ("native": the fill's exact redo is the native engine's, else
    sample_setup.exact_engine's), check_kernels (hold each pairing sweep
    and each accumulation (accumulate_pileup) of a run to the plain
    versions on its inputs, after the run) and runs, a list of
    dicts: name, kernel, opts (opt_args overrides), fill (run_with_fill,
    else mesh_stats).  Returns this rank's shard index, its world's load
    time, its peak device memory and each run's stats and rows (numpy),
    stage times, wall time, launches, first-pass fallback, files, the
    sweeps held ((pairs, k_occ, cnt_chg) each) and the accumulations held
    ((B, L, marker_base's largest offset or None) each)."""
    from .kernels import build
    from .testing.accumulate_cases import check_launches, recorded_launches
    from .testing.pairing_cases import check_sweeps, recorded_sweeps

    rank = 0 if mesh is None else mesh.shard_index()
    t0 = time.perf_counter()
    world = world_from_files(spec["tmp"], spec["idx_prefix"], spec["fq1"],
                             spec["fq2"], "r_1.fq", "r_2.fq",
                             device=spec.get("device", "cuda"),
                             L=spec.get("L", 256),
                             bitmaps=spec.get("bitmaps", False))
    dev = world["device"]
    load_s = time.perf_counter() - t0
    engine = None
    if spec.get("engine") == "native":
        from .align.engine import NativeEngine

        engine = NativeEngine(world["idx"])  # raises without its library
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    runs = {}
    for run in spec["runs"]:
        world["opt_args"].update(run.get("opts", {}))
        build.reset_launch_counts()
        times: dict = {}
        fb1 = None
        sweeps: list = []
        accums: list = []
        check = spec.get("check_kernels")
        record = recorded_sweeps(sweeps) if check \
            else contextlib.nullcontext()
        record_acc = recorded_launches(accums) if check \
            else contextlib.nullcontext()
        t0 = time.perf_counter()
        with record, record_acc:
            if run.get("fill"):
                stats, rows, fb1 = run_with_fill(
                    world, engine, spec.get("pileup_cap", 64), run["kernel"],
                    times, mesh=mesh)
            else:
                stats, rows = mesh_stats(world, mesh,
                                         spec.get("pileup_cap", 64),
                                         run["kernel"], times=times)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = dict(build.launch_counts)
        held = check_sweeps(sweeps, f"rank {rank}, run {run['name']}")
        acc_held = check_launches(accums, f"rank {rank}, run {run['name']}")
        del accums
        files = []
        if rank == 0 and spec.get("out_dir"):
            files = write_product(f"{spec['out_dir']}/{run['name']}", stats,
                                  rows, world["names"], world)
        runs[run["name"]] = dict(
            stats={k: _host(v) for k, v in stats.items()}, rows=rows,
            times=times, wall_s=wall, launches=launches, fallback_first=fb1,
            files=files, sweeps_held=held, accumulations_held=acc_held)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    return dict(rank=rank, load_s=load_s, peak_bytes=peak, runs=runs,
                n_pairs=world["n_pairs"])


def same_files(fa: list, fb: list, tag: str) -> int:
    """Two write_product file lists: the same products (at least 12), each
    pair byte-identical; raises otherwise.  Returns the count."""
    import filecmp
    import os

    names = [[os.path.basename(f).split(".", 1)[1] for f in x]
             for x in (fa, fb)]
    if names[0] != names[1] or len(fa) < 12:
        raise AssertionError(f"{tag}: product files {names[0]} vs "
                             f"{names[1]}")
    diffs = [os.path.basename(x) for x, y in zip(fa, fb)
             if not filecmp.cmp(x, y, shallow=False)]
    if diffs:
        raise AssertionError(f"{tag}: product files differ: {diffs}")
    return len(fa)


def same_run(a: tuple, b: tuple, what: str, skip=()) -> None:
    """Two one-program runs' (stats, rows) identical: every accumulator and
    row field exactly, the insert-size estimate's floats within 1e-6
    relative; stats are torch or numpy; keys in skip are not held.
    Raises AssertionError naming what differs."""
    def host(v):
        return v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)

    (sa, ra), (sb, rb) = a, b
    bad = sorted(set(sa) ^ set(sb)) + sorted(set(ra) ^ set(rb))
    for k in set(sa) & set(sb) - set(skip):
        x, y = host(sa[k]), host(sb[k])
        if k == "_ii":
            if not np.allclose(x, y, rtol=1e-6, atol=0):
                bad.append(k)
        elif x.dtype != y.dtype or not np.array_equal(x, y):
            bad.append(k)
    bad += [f"row {k}" for k in set(ra) & set(rb)
            if not np.array_equal(ra[k], rb[k])]
    if bad:
        raise AssertionError(f"{what}: differ in {sorted(bad)}")


def diff_world(a: dict, b: dict, tag: str) -> tuple[int, int, list]:
    """Two mesh_job results (each rank 0's) of one world and run: their
    product files must be byte-identical.  Returns (n_mapped, n_pair_reads,
    files of b)."""
    (ra,), (rb,) = a["runs"].values(), b["runs"].values()
    n_mapped = int(rb["stats"]["n_mapped"])
    if n_mapped <= 0:
        raise AssertionError(f"no reads mapped in dry-run world {tag}")
    same_files(ra["files"], rb["files"], tag)
    return n_mapped, int(rb["stats"]["n_pair_reads"]), rb["files"]


def dryrun_multichip(n: int, device="cuda", tmp: str | None = None,
                     world: dict | None = None,
                     world_kw: dict | None = None) -> dict:
    """The synthetic half of the reference's multichip dry run: the full
    step on testing/synthworld.build_synth_pe_world (`world`, else built
    under tmp with world_kw) at mesh-n against mesh-n/2 (one device, in
    this process, when n is 2), each over ranks that parallel/mesh.spawn
    starts with gloo collectives (a 2-D ('host', 'chip') mesh of 2 hosts
    when n >= 4 is even), every product file byte-identical.  device:
    every rank's (ranks share the card).  The example-world half needs
    the reference's bundled example and is not here.  Returns each mesh
    size's per-rank mesh_job results and the diff's counts; raises on a
    difference or a failed rank."""
    import os
    import tempfile

    from .parallel.mesh import spawn
    from .testing.synthworld import build_synth_pe_world

    if world is None:
        tmp = tmp or tempfile.mkdtemp(prefix="fq_dryrun_synth_")
        world = build_synth_pe_world(tmp, **(world_kw or {}))
    build_native()
    base = os.path.join(str(world["tmp"]), "dryrun")
    spec = dict(tmp=str(world["tmp"]), idx_prefix=world["idx_prefix"],
                fq1=world["fq1"], fq2=world["fq2"], device=device,
                pileup_cap=128, runs=[dict(name="synth", kernel="resident")])
    out = {}
    for nd in (n // 2, n):
        s = dict(spec, out_dir=f"{base}_mesh{nd}")
        os.makedirs(s["out_dir"], exist_ok=True)
        if nd == 1:
            out[nd] = [mesh_job(None, s)]
        else:
            hosts = 2 if nd >= 4 and nd % 2 == 0 else None
            out[nd] = spawn(mesh_job, nd, (s,), hosts=hosts)
    n_mapped, n_pair, files = diff_world(out[n // 2][0], out[n][0], "synth")
    print(f"dryrun_multichip OK: mesh-{n} against mesh-{n // 2} on the "
          f"synthetic world ({2 * out[n][0]['n_pairs']} PE reads, {n_mapped} "
          f"mapped, {n_pair} proper-pair reads): {len(files)} product files "
          f"byte-identical: "
          f"{[os.path.basename(f).split('.', 1)[1] for f in files]}")
    return dict(runs=out, n_mapped=n_mapped, n_pair_reads=n_pair,
                files=files)
