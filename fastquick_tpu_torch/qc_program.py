"""The one-program QC step (ops/qc_full.qc_step_full) on one device: worlds,
runs and the product files.

Counterpart of the single-device half of the reference's
``__graft_entry__.py``: ``entry`` is its compile-check entry, and
``world_from_files`` / ``run_single`` / ``write_product`` its dry run's
world, step and writers, with ``device`` chosen by the caller (cuda by
default; "cpu" runs every kernel's plain version).  ``run_with_fill`` is
the two-dispatch recipe that makes the drand48 stream exact on a batch
with fallback reads: run once, redo the fallback reads with the exact
native (else host) engine, pack their hit lists and run again with them
filled in.

    from fastquick_tpu_torch import qc_program as qp
    world = qp.world_from_files(tmp, idx_prefix, fq1, fq2, "a_1.fq",
                                "a_2.fq", device="cpu")
    stats, rows = qp.run_single(world)
    qp.write_product(prefix, stats, rows, world["names"], world)
"""

from __future__ import annotations

import copy
import glob
import time

import numpy as np
import torch

from .align.opts import GapOpt, PeOpt, bwa_cal_maxdiff
from .ops.qc_full import (
    build_site_tables,
    count_pcr_dups,
    pack_host_hits,
    qc_step_full,
    synthetic_site_tables,
)
from .utils.device import resolve_device

_STATUS = ["PropPair", "PartialPair", "FwdOnly", "RevOnly", "NotPair",
           "LowQual"]


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
    reads (``reads``, in row order) for run_with_fill's host redo."""
    from .align.seqs import FastqReader, read_batch
    from .index.builder import load_index, read_param
    from .ops.fm import DeviceFM
    from .ops.kmer import load_kmer_bitmaps
    from .stats.collector import StatCollector

    dev_t = resolve_device(device)
    new_ref = f"{idx_prefix}.FASTQuick.fa"
    params = read_param(new_ref)
    opt = GapOpt()
    opt.num_variant_long = params["NUM_VAR_LONG"]
    opt.num_variant_short = params["NUM_VAR_SHORT"]
    opt.flank_len = params["SHORT_FLANK_LENGTH"]
    opt.flank_long_len = params["LONG_FLANK_LENGTH"]
    popt = PeOpt()
    idx = load_index(new_ref)
    collector = StatCollector()
    collector.restore_vcf_sites(new_ref, opt)
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
    world = dict(tmp=tmp, idx=idx, opt=opt, new_ref=new_ref, tables=tables,
                 fm=fm, opt_args=opt_args,
                 md_table=torch.from_numpy(md_np).to(dev_t), arrays=arrays,
                 names=names, reads=reads, n_pairs=len(b0),
                 n_base=sum(p.full_len for p in b0 + b1), fname1=fname1,
                 fname2=fname2, device=dev_t)
    if bitmaps:
        world["bitmaps"] = load_kmer_bitmaps(idx.kmer.byte_bitmaps(), dev_t)
        world["thresh"] = idx.kmer.thresh
    return world


def write_product(prefix, acc, rows, names, world) -> list[str]:
    """Merge one run's device state into a fresh StatCollector and write
    the product files (the same writers the align stage uses); the
    .InsertSizeTable rows are rendered from the per-pair fields.  Returns
    the written paths, sorted."""
    from .stats.collector import FileStat, StatCollector
    from .stats.device_merge import populate_from_device

    idx, opt = world["idx"], world["opt"]
    collector = StatCollector()
    collector.restore_vcf_sites(world["new_ref"], opt)
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
               per_read: bool = False):
    """The whole batch as one pair-mode step on the world's device.
    Returns (stats, rows[, per_read]): the accumulators with n_pcr_dup
    (tensors on the device) and the per-pair rows as numpy arrays."""
    seqs, rseqs, quals, lens = world["arrays"]
    out = qc_step_full(world["fm"], world["tables"], world["opt_args"],
                       seqs, rseqs, quals, lens,
                       bitmaps=world.get("bitmaps"),
                       thresh=world.get("thresh", 3),
                       md_table=world["md_table"], pair_mode=True,
                       pileup_cap=pileup_cap, kernel=kernel, times=times,
                       fb_fill=fb_fill, pe_fill=pe_fill,
                       return_per_read=per_read)
    stats, pr = out if per_read else (out, None)
    stats["n_pcr_dup"] = count_pcr_dups(stats.pop("_pair_keys"))
    rows = {k: v.cpu().numpy() for k, v in stats.pop("_pair_rows").items()}
    return (stats, rows, pr) if per_read else (stats, rows)


def default_engine(idx):
    """The exact engine for fallback reads: native, else host (when the
    native aligner's library is unavailable)."""
    try:
        from .align.engine import NativeEngine

        return NativeEngine(idx)
    except RuntimeError:
        from .align.engine import HostEngine

        return HostEngine(idx)


def run_with_fill(world, engine=None, pileup_cap: int = 64,
                  kernel: str = "resident", times: dict | None = None):
    """The two-dispatch recipe: run the step once, redo its fallback reads
    with `engine` (default_engine), pack their hit lists (pack_host_hits)
    and run again with them as fb_fill, so every read carries exact hits
    and the drand48 stream consumes them in read order.  Returns (stats,
    rows, the first pass's fallback count).  times: the second pass's
    stages plus "first_pass" and "host_redo" (seconds)."""
    dev = world["device"]
    t0 = time.perf_counter()
    _, _, pr = run_single(world, pileup_cap, kernel, per_read=True)
    fb = pr["fallback"].cpu().numpy() != 0
    t1 = time.perf_counter()
    rows_idx = np.nonzero(fb)[0]
    reads = [copy.copy(world["reads"][b]) for b in rows_idx]
    if reads:
        (engine or default_engine(world["idx"])).align_batch(reads,
                                                             world["opt"])
    fb_n, fb_rows = pack_host_hits(reads, rows_idx, fb.shape[0])
    fill = (torch.from_numpy(fb_n).to(dev), torch.from_numpy(fb_rows).to(dev))
    t2 = time.perf_counter()
    stats, rows = run_single(world, pileup_cap, kernel, times=times,
                             fb_fill=fill)
    if times is not None:
        times["first_pass"] = t1 - t0
        times["host_redo"] = t2 - t1
    return stats, rows, int(fb.sum())
