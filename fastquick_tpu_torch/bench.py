"""Aligned reads per second, on the card unless asked for the CPU.

Counterpart of the repository's root bench.py.  It builds the same
synthetic world (a random text, 2 Mbp by default, and a read mix of 85%
reads with ~1% base errors, 10% clean reverse complements and 5% junk)
from the same seeds, step for step, and times one of three modes
(``FQ_BENCH_ENGINE``):

- ``native`` (the default): the native engine, best of ``FQ_BENCH_REPS``
  passes.  The default run then also runs ``cuda`` and ``e2e`` on the same
  world and folds them into its line as ``cuda_*`` and
  ``e2e_reads_qc_per_sec_per_chip``;
- ``cuda``: ``ops/batch_search.BatchEngine`` on the same reads (width and
  search kernels, the exact native redo of the reads they cannot finish),
  every read's hits held to the native engine's; it reports the kernel,
  iterations, fallback reads and causes, the busy share of the lanes'
  steps, the bytes the searches must move (utils/bounds.search_bytes) and
  that count's share of the card's HBM rate;
- ``e2e``: the device k-mer filter over a stream of ``FQ_BENCH_STREAM``
  reads (3% from the filter's flanks), then the native alignment of the
  survivors.

    python -m fastquick_tpu_torch.bench [--device cuda|cpu]

It prints exactly one JSON line, which names the device it ran on: the
card's name and power limit, or "cpu".  A mode that fails raises, and the
bench exits non-zero.  Every host-clock interval ends in a synchronise of
the card.  The reference's paired baseline (its libbwa, compiled from the
reference tree) is not available to the port: the baseline is the root
bench's own estimate (``baseline_source: "estimate"``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .align.opts import GapOpt
from .utils.bounds import HBM_BYTES_S
from .utils.device import resolve_device

BASELINE_READS_PER_SEC_PER_CORE = 25_000.0
BASELINE_READS_PER_SEC = BASELINE_READS_PER_SEC_PER_CORE * (os.cpu_count()
                                                            or 4)
# the root bench's estimate for the filter-dominated e2e stream
BASELINE_E2E_READS_PER_SEC = 1_000_000.0
# reads of the warm-up pass ahead of the timed ones (fewer if the run has
# fewer): the first BatchEngine call builds the CUDA library and uploads
# the FM table
WARM_READS = 2048
# the k-mer filter's flanks: the text's first 400 kb in 2,001-bp contigs
E2E_FLANK_BP = 400_000
E2E_CONTIG = 2001
# what the cuda mode reports beside the baseline keys (the root bench's
# tpu-mode keys, with the bytes the searches must move in place of its
# TPU byte model)
CUDA_KEYS = ("kernel", "iters", "fallback_reads", "fallback_causes",
             "busy_lane_frac", "bytes_moved", "achieved_GBps",
             "hbm_sol_frac", "launches")


def build_index(n_bp: int, seed: int = 0):
    """The bench's reduced index: a random text of n_bp bases (the root
    bench's generator), one contig, an empty k-mer filter."""
    from .index.builder import ContigInfo, ReducedIndex
    from .index.fmindex import FMIndex
    from .index.kmerfilter import KmerFilter

    rng = np.random.default_rng(seed)
    text = rng.integers(0, 4, n_bp).astype(np.uint8)
    fm_f = FMIndex.build(text)
    fm_r = FMIndex.build(text[::-1].copy())
    contigs = [ContigInfo("1:1000@A/C", 0, n_bp, "1", 1000, "A", "C", False)]
    kmer = KmerFilter([np.zeros(0, np.uint32)] * 6, thresh=0)
    return ReducedIndex(fm_fwd=fm_f, fm_rev=fm_r, text=text, contigs=contigs,
                        contig_offsets=np.array([0]), kmer=kmer, ambs=[])


def make_reads(idx, n_reads: int, read_len: int, seed: int = 1):
    """The bench's read mix, drawn as the root bench draws it: of every 20
    reads, 17 copies with ~1% base errors (every other one reverse
    complemented), 2 clean reverse complements and 1 junk read."""
    from .align.seqs import Read, seq_reverse

    rng = np.random.default_rng(seed)
    text = idx.text
    reads = []
    for r in range(n_reads):
        start = int(rng.integers(0, len(text) - read_len))
        codes = text[start:start + read_len].copy()
        u = r % 20
        if u < 17:  # matching read with ~1% errors
            nerr = rng.binomial(read_len, 0.01)
            for _ in range(nerr):
                p = int(rng.integers(0, read_len))
                codes[p] = (codes[p] + int(rng.integers(1, 4))) % 4
            if u % 2 == 1:
                codes = (3 - codes)[::-1].copy()
        elif u < 19:  # clean revcomp
            codes = (3 - codes)[::-1].copy()
        else:  # junk
            codes = rng.integers(0, 4, read_len).astype(np.uint8)
        p = Read()
        p.len = p.full_len = p.clip_len = read_len
        p.seq = seq_reverse(codes, False)
        p.rseq = seq_reverse(codes, True)
        p.qual = rng.integers(53, 73, read_len).astype(np.uint8)
        reads.append(p)
    return reads


def device_info(dev: torch.device):
    """"cpu", or the card's name and the power limit nvidia-smi prints for
    it (raises where nvidia-smi cannot read it)."""
    if dev.type == "cpu":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    line = smi.stdout.strip().splitlines()[dev.index or 0]
    return {"name": torch.cuda.get_device_name(dev),
            "power_limit": line.rsplit(",", 1)[1].strip()}


def sync(dev: torch.device) -> None:
    """Wait for the card (nothing on the CPU): call before a host clock
    read."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def hit_keys(reads) -> list:
    """Every read's hit multiset (the key of the root sweep's check)."""
    return [sorted((a.n_mm, a.n_gapo, a.n_gape, a.a, a.k, a.l, a.score)
                   for a in p.aln) for p in reads]


def first_mismatch(reads, gold) -> int | None:
    """The first read whose hits differ from gold's, else None."""
    for i, (k, g) in enumerate(zip(hit_keys(reads), gold)):
        if k != g:
            return i
    return None


def timed_passes(engine, reads, opt, reps: int, dev) -> list[float]:
    """Seconds of `reps` passes of engine.align_batch over the reads."""
    times = []
    for rep in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        engine.align_batch(reads, opt)
        sync(dev)
        times.append(time.perf_counter() - t0)
        print(f"# pass {rep + 1}/{reps}: {times[-1]:.3f}s", file=sys.stderr)
    return times


def run_native(idx, reads, opt, reps: int) -> dict:
    """The native engine, best of `reps` passes after a warm-up."""
    from .align.engine import NativeEngine

    engine = NativeEngine(idx)
    warm = make_reads(idx, min(WARM_READS, len(reads)), reads[0].len,
                      seed=7)
    engine.align_batch(warm, opt)
    times = timed_passes(engine, reads, opt, reps, torch.device("cpu"))
    return dict(rps=len(reads) / min(times), times=times,
                mapped=sum(1 for p in reads if p.aln))


def run_cuda(idx, reads, opt, dev, reps: int, gold, **engine_kw) -> dict:
    """BatchEngine(idx, dev, **engine_kw), best of `reps` passes after a
    warm-up, with the launch counts zeroed just before the timed passes.
    ok: every read's hits equal gold's (hit_keys of the native engine)."""
    from .kernels import build
    from .ops.batch_search import BatchEngine

    engine = BatchEngine(idx, dev, **engine_kw)
    warm = make_reads(idx, min(WARM_READS, len(reads)), reads[0].len,
                      seed=7)
    sync(dev)
    t0 = time.perf_counter()
    engine.align_batch(warm, opt)
    sync(dev)
    warm_s = time.perf_counter() - t0
    build.reset_launch_counts()
    times = timed_passes(engine, reads, opt, reps, dev)
    launches = {k: v for k, v in build.launch_counts.items() if v}
    dt = min(times)
    bad = first_mismatch(reads, gold)
    on_card = dev.type == "cuda"
    return dict(
        rps=len(reads) / dt, times=times, warm_s=warm_s, ok=bad is None,
        first_mismatch=bad, kernel=engine.kernel, iters=engine.last_iters,
        fallback_reads=engine.last_fallback,
        fallback_causes=dict(engine.last_fb_causes),
        busy_lane_frac=round(engine.last_busy
                             / max(engine.last_lane_steps, 1), 3),
        bytes_moved=engine.last_bytes,
        # device rates only from the card
        achieved_GBps=(round(engine.last_bytes / dt / 1e9, 3) if on_card
                       else None),
        hbm_sol_frac=(engine.last_bytes / dt / HBM_BYTES_S if on_card
                      else None),
        launches=launches)


def e2e_stream(idx, n_reads: int, read_len: int):
    """The e2e mode's filter and stream, as the root bench makes them: the
    filter over the text's first 400 kb (all of a shorter text) in
    2,001-bp contigs, and n_reads reads of read_len codes, the first 3%
    drawn from those flanks with ~0.5% errors, the rest random.  Returns
    (KmerFilter, seqs (n, L) int32, lens (n,) int32)."""
    from .index.kmerfilter import KmerFilterBuilder

    rng = np.random.default_rng(11)
    flank_bp = min(E2E_FLANK_BP, len(idx.text))
    text_str = "".join("ACGT"[c] for c in idx.text[:flank_bp])
    kb = KmerFilterBuilder()
    for s in range(0, len(text_str) - E2E_CONTIG, E2E_CONTIG):
        kb.add_seq(text_str[s:s + E2E_CONTIG], ("A", "C"))
    filt = kb.finalize()
    n_marker = int(n_reads * 0.03)
    seqs = np.zeros((n_reads, read_len), dtype=np.int32)
    for i in range(n_reads):
        if i < n_marker:
            s = int(rng.integers(0, flank_bp - read_len))
            codes = idx.text[s:s + read_len].astype(np.int32)
            nerr = rng.binomial(read_len, 0.005)
            for _ in range(nerr):
                p = int(rng.integers(0, read_len))
                codes[p] = (codes[p] + 1) % 4
        else:
            codes = rng.integers(0, 4, read_len).astype(np.int32)
        seqs[i] = codes
    return filt, seqs, np.full(n_reads, read_len, dtype=np.int32)


def run_e2e(idx, n_reads: int, read_len: int, dev, reps: int,
            chunks: int = 1) -> dict:
    """The device k-mer filter over the stream, in `chunks` launches all
    queued before the first survivors come back, and the native alignment
    of the survivors of each chunk; best of `reps` passes after a warm-up.
    The bitmaps (6 x 512 MiB) and the stream are on `dev` before the
    clock starts.  Returns rps, kept (the count) and survivors (the kept
    reads' indices)."""
    from .align.engine import NativeEngine
    from .align.seqs import Read, seq_reverse
    from .ops.kmer import filter_reads, load_kmer_bitmaps

    t0 = time.perf_counter()
    filt, seqs, lens = e2e_stream(idx, n_reads, read_len)
    bitmaps = load_kmer_bitmaps(filt.byte_bitmaps(), dev)
    # on the card the host copy goes; on the CPU the tensors are views of it
    filt._byte_bitmaps = None
    seqs_d = torch.from_numpy(seqs).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    sync(dev)
    print(f"# e2e: filter built and uploaded, stream made in "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
    engine = NativeEngine(idx)
    opt = GapOpt()
    bounds = [(n_reads * c // chunks, n_reads * (c + 1) // chunks)
              for c in range(chunks)]

    def one_pass():
        sync(dev)
        t0 = time.perf_counter()
        kept_d = [filter_reads(bitmaps, seqs_d[a:b], lens_d[a:b],
                               filt.thresh) for a, b in bounds]
        survivors, n_hits = [], 0
        for (a, _), kd in zip(bounds, kept_d):
            idx_kept = np.nonzero(kd.cpu().numpy())[0] + a
            reads = []
            for i in idx_kept:
                p = Read()
                codes = seqs[i].astype(np.uint8)
                p.len = p.full_len = p.clip_len = read_len
                p.seq = seq_reverse(codes, False)
                p.rseq = seq_reverse(codes, True)
                p.qual = np.full(read_len, 70, np.uint8)
                reads.append(p)
            engine.align_batch(reads, opt)
            survivors.append(idx_kept)
            n_hits += sum(1 for p in reads if p.aln)
        sync(dev)
        return time.perf_counter() - t0, np.concatenate(survivors), n_hits

    one_pass()  # warm the filter's shapes and the engine's caches
    best = min((one_pass() for _ in range(reps)), key=lambda r: r[0])
    total, survivors, n_hits = best
    print(f"# e2e: {n_reads} reads in {total:.3f}s, {len(survivors)} kept, "
          f"{n_hits} with hits", file=sys.stderr)
    return dict(rps=n_reads / total, kept=len(survivors),
                survivors=survivors, hits=n_hits)


def knobs() -> dict:
    """The root bench's environment knobs, with its names and defaults;
    FQ_BENCH_ENGINE takes native | cuda | e2e."""
    env = os.environ.get
    out = dict(n_bp=int(env("FQ_BENCH_REF_BP", 2_000_000)),
               n_reads=int(env("FQ_BENCH_READS", 32768)),
               read_len=int(env("FQ_BENCH_READ_LEN", 151)),
               n_stream=int(env("FQ_BENCH_STREAM", 262144)),
               reps=int(env("FQ_BENCH_REPS", 3)),
               chunks=int(env("FQ_BENCH_E2E_CHUNKS", 1)),
               which=env("FQ_BENCH_ENGINE", "native"))
    if out["which"] not in ("native", "cuda", "e2e"):
        raise ValueError(f"FQ_BENCH_ENGINE={out['which']!r}: native, cuda "
                         "or e2e")
    return out


def bench(dev: torch.device, k: dict) -> dict:
    """One run of the mode k["which"] on `dev`; returns its JSON line."""
    t0 = time.perf_counter()
    idx = build_index(k["n_bp"])
    print(f"# index built: {k['n_bp']} bp in {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)
    info = device_info(dev)
    if k["which"] == "e2e":
        r = run_e2e(idx, k["n_stream"], k["read_len"], dev, k["reps"],
                    k["chunks"])
        return {"metric": "reads_qc_per_sec_per_chip",
                "value": round(r["rps"], 1), "unit": "reads/s",
                "vs_baseline": round(r["rps"] / BASELINE_E2E_READS_PER_SEC,
                                     3),
                "kept": r["kept"], "device": info}
    opt = GapOpt()
    reads = make_reads(idx, k["n_reads"], k["read_len"], seed=1)
    if k["which"] == "cuda":
        gold_reads = make_reads(idx, k["n_reads"], k["read_len"], seed=1)
        run_native(idx, gold_reads, opt, 1)
        gold = hit_keys(gold_reads)
        del gold_reads
        r = run_cuda(idx, reads, opt, dev, k["reps"], gold)
    else:
        r = run_native(idx, reads, opt, k["reps"])
    out = {"metric": "aligned_reads_per_sec", "value": round(r["rps"], 1),
           "unit": "reads/s",
           "vs_baseline": round(r["rps"] / BASELINE_READS_PER_SEC, 3),
           "baseline_reads_per_sec": round(BASELINE_READS_PER_SEC, 1),
           "baseline_source": "estimate"}
    print(f"# engine={k['which']}: {k['n_reads']} reads in "
          f"{min(r['times']):.3f}s (best of {k['reps']})", file=sys.stderr)
    if k["which"] == "cuda":
        if not r["ok"]:
            raise AssertionError(f"cuda mode: read {r['first_mismatch']}'s "
                                 "hits differ from the native engine's")
        out["engine"] = "cuda"
        out.update({key: r[key] for key in CUDA_KEYS})
        out["device"] = info
        return out
    # the default run: the device engine on the same reads, then e2e
    gold = hit_keys(reads)
    c = run_cuda(idx, reads, opt, dev, k["reps"], gold)
    if not c["ok"]:
        raise AssertionError(f"cuda sub-run: read {c['first_mismatch']}'s "
                             "hits differ from the native engine's")
    out["cuda_reads_per_sec"] = round(c["rps"], 1)
    out.update({f"cuda_{key}": c[key] for key in CUDA_KEYS})
    e = run_e2e(idx, k["n_stream"], k["read_len"], dev, k["reps"],
                k["chunks"])
    out["e2e_reads_qc_per_sec_per_chip"] = round(e["rps"], 1)
    out["e2e_kept"] = e["kept"]
    out["device"] = info
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(json.dumps(bench(dev, knobs())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
