#!/usr/bin/env python3
"""Drive fastquick_tpu_torch's pipeline on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card, ~13 minutes

Phases (any failure raises and the script exits non-zero):

1. card: the card's name and power limit (nvidia-smi), the kernels' build
   from fastquick_tpu_torch/csrc (nvcc, sm_90a) and its time, and ptxas's
   registers, stack frame, spills and static shared memory per kernel;
2. kernels: each CUDA kernel against its plain PyTorch version on the card,
   exact integer equality, at the main path's shapes, over an FM index of
   a seeded random 6.5 Mbp text (the production panel's size): width on
   65,536 units of 160 codes and on edge batches (testing/width_cases.py,
   L 1 to 160 with the seed launches' 32), search on 4,096 reads of 150
   bp, SW on 2,048 jobs of 640 x 128 and on an edge batch (testing/
   sw_cases.py); kernel and plain times by CUDA events; the search kernel
   is also timed alone on one full chunk of 32,768 reads, with the pools'
   high-water marks (p50, p99, max) of both cells and the time of one step
   of the longest read.  The scan path (``FQ_BS_PALLAS=2``: 1,024 lanes x
   32 steps, pool 512, step cap 768) runs the same 4,096 reads as one
   launch of the scan kernel and as its plain version, which must agree in
   hits, fallbacks, steps, rounds and busy steps, and both must equal the
   resident kernel at that pool and cap read for read; the kernel's launch
   and the whole chunk are timed.  The resident kernel also runs at chain
   length 4 (qc_step_full's default: up to 4 exact-walk bases a step,
   fq_search_chain_kernel, counted as "search_chain") on the same reads,
   equal to its plain version in hits, fallbacks, steps and pool
   high-water marks: at a step cap of 256 that binds, with a fallback set
   other than chain 1's and both chain lengths timed, and at qc_step_full's
   own pool 256 and step cap 64 L, where most reads overflow the pool
   (timed: the search_chain entry); the drand48 kernel draws on 65,536
   reads of random hit lists (testing/drand48_cases.py; the kernels
   line's numbers), on a production-shaped batch of 200,000 mostly
   single-row reads, and on that batch from the state whose first draw at
   read 123,457 is 0 (the kernel's speculation breaks and resumes there),
   each equal to its plain version in the selected words, rows and stream
   state, timed; and the pairing kernel runs on 100,000 pairs at k_occ 32
   (qc_step_full's first pass; the kernels line's numbers) and on 64 pairs
   at k_occ2 512 (its second pass) of testing/pairing_cases.py, equal to
   pairing_sweep_plain in every output field and cnt_chg; pairing_sweep
   makes one launch, which orders, sweeps and finishes every pair: that
   launch timed by CUDA events around it, and the wrapper with its
   penalty table; the accumulation kernels (testing/accumulate_cases.py):
   the edge cases (with "all_markers": a walk block lists more entries
   than its shared buffer holds), then 200,000 production-shaped reads x
   150 over the same text with 10,000 markers, some read 100 deep past
   the pileup cap of 64: accumulate_pileup (the one-program step's one
   walk of the grid and its order launch, which must be one launch each)
   equal to accumulate_plain and pileup_plain with no slot offsets and
   with random ones, accumulate (the walk's sums alone) and pileup (its
   entries alone, then the order) equal to theirs; a DeviceDenseStats
   chunk of 4,096 x 150 uint8 reads into fresh and into resident sums
   equal to dense_accumulate_plain; and DeviceDenseStats itself on the
   card over three deferred flushes and one drain, the collector's arrays
   equal to the plain sums of its chunks, one copy to the host.  Each
   walk and order launch timed by CUDA events around it (the kernels
   line's accumulate entry: accumulate_pileup's walk and order, its
   pileup entry: pileup's), the wrappers and the plain versions (the
   torch ops the kernels replace) too;
3. small world: the port's ``index`` + ``align --device_qc`` on
   testing/synthworld.build_synth_pe_world, byte-identical on all 12
   product files to the port's ``align --engine native`` (the CPU tests
   hold the device path to the reference's align on this world), once
   with the default (resident) search kernel and once with
   ``FQ_BS_PALLAS=2``;
4. production: the world of tools/stress_production_scale.py (10,000
   markers, 100,000 read pairs of 150 bp) from --seed; ``align
   --device_qc`` byte-identical to ``align --engine native``; phase
   times, reads a second, fallback share (fails above a quarter); then
   the same device run with ``FQ_BS_PALLAS=2`` (byte-identical, its share
   printed, not gated: pool 512 and cap 768 are the reference's settings
   for that path).  The default run logs the shapes of its width launches
   (units x codes) and its SW launches (jobs, RL, QL, true cells), and
   both kernels are checked and timed again at those shapes after it, as
   is its first DeviceDenseStats chunk (the walk's inputs and the
   resident sums before and after it) against the plain version; the
   run's dense sites S, the host-clock time inside DeviceDenseStats.flush
   and its copies to the host (tools/dense_flush_probe.timed_flush), which
   must be one copy of the sums.  The kernel launch counts are zeroed
   right before each device run and read right after it; each device run
   must launch the accumulation walk;
5. program: the one-program QC step (qc_program, ops/qc_full.qc_step_full)
   in pair mode with drand48 on.  On the small world's files, run_single
   on the card and on the CPU (the plain versions): every accumulator,
   every per-pair row field and the product files write_product writes
   must be identical.  On the production world's files (phase 4's, else
   built), all 100,000 pairs as one batch of 200,000 reads of L 160 with
   the k-mer bitmaps on the card: run_with_fill with the resident kernel
   at qc_full's defaults (pool 256, chain 4, step cap 64 L) and with the
   scan kernel (chain 1, pool 512, cap 768); after the fill pass both have
   no fallback left and must agree on every accumulator, n_pcr_dup, every
   row and every product file.  The exact redo is the card's retry of
   the pool overflows, then the native engine's; each run's fill is held
   bit-identical to the native engine's object route on every fallback
   row and to the Python oracle's on 256 of them, with the retry's
   counters and its launches' times by CUDA events.  Each run logs its
   first pass's fallback, its stages' wall times (the card synced at
   each boundary), reads a second, its counters and its launches,
   zeroed right before it, with its pairing, second_pass and
   drand48 stages apart, and the fill pass's pairing stage split into
   its isize inference, two expansions and sweep by CUDA events around
   them; its pairing kernel launches must equal the sweeps it ran.
   After each run, every drand48 launch, every pairing sweep and every
   accumulation (accumulate_pileup, first pass and fill pass: one walk
   of the grid and one order launch each, as the launch counts must
   show) it made is held to the plain versions on its own inputs (and
   timed again on them), and the resident run's first-pass search launch
   to the plain search on 4,096 evenly spaced reads of its chunk.

6. pipeline: the stages after align.  On the small world (phase 3's),
   ``align --device_qc --shard_out`` on each half of its FASTQs by
   record, then ``merge``: the shard BAMs and the 11 merged product files
   byte-identical to native shards and their merge; against phase 3's
   single device run, DepthDist, GCDist, EmpRepDist, EmpCycleDist and
   the Pileup's per-marker depths and sorted bases equal (the insert-size
   files and the Summary are printed, not held: a shard restarts the
   drand48 stream that the repeat markers' reads draw their hits from,
   in the reference as well).  On the production world (phase 4's),
   a panel of 60 samples at every fourth marker
   (testing/synthworld.write_panel), then ``fastquick-torch all --steps
   AllButIndex --device cuda --RefVCF <panel>`` (SVD build, align on the
   device path, pop+con, report) with the launch counts zeroed just
   before it; where matplotlib is not installed, all's stages by their
   own commands in all's order, without the report.  The 12 align
   product files byte-identical to phase 4's native run; width, search
   and SW launched; each stage's wall time, FREEMIX and the Ancestry PCs.
   Then ``pop+con --DeviceLLK --device cuda`` on the same Pileup (FREEMIX
   within 5e-3 of numpy's); DeviceLLK on the card within rel 2e-5 of the
   numpy likelihood at three points; one evaluation's time on the card
   and in numpy, and the evaluations and wall time of each solve;
7. mesh: ranks that share the card, started by parallel/mesh.spawn with
   gloo collectives on host copies, after the kernel and native libraries
   are built here.  The small world at mesh-4 (2 x 2) against mesh-2
   (qc_program.dryrun_multichip): all 13 product files byte-identical.
   The production files at mesh-2, run_with_fill with the resident
   kernel at qc_full's defaults and with the scan kernel, each rank
   redoing its own fallback reads (the card's retry, then the native
   engine): every accumulator (n_reads aside), n_pcr_dup, row,
   _drand_state and the 13 product files identical to phase 5's
   single-device runs (made here when phase 5 did not run), every rank
   equal, each rank's width, search (chain 4) or scan and drand48
   kernels launched, and each of its pairing sweeps, one launch each,
   and each of its accumulations (with its marker_base; a walk and an
   order launch each) held to the plain versions on its own inputs
   after its run.  Each rank logs
   its world's load time, stage times (with "exchange": the collectives
   and the merge, waiting for the slowest rank included), whole wall
   time, launches and peak device memory.  Then DeviceLLK sharded over 2
   ranks on phase 6's pileup (a seeded panel's when phase 6 did not
   run): within rel 1e-5 of the unsharded one at three points, and
   ``pop+con --DeviceLLK`` in each rank, sharded by the driver, FREEMIX
   within 5e-3 of numpy's;
8. bench: the benchmark entry points as a user runs them, each a
   process of its own, at cut sizes (4,096 reads, a stream of 32,768,
   one timed pass): ``python -m fastquick_tpu_torch.bench`` (the native
   engine, then the cuda mode on the same reads, hits equal to native,
   then the e2e stream), its ``cuda`` and ``e2e`` modes alone, and
   ``python -m fastquick_tpu_torch.sweep`` on three configs (resident at
   chain 1 and 4, scan).  Each prints its JSON line(s) with the card's
   name and power limit, exits 0, no number null; the bench's cuda runs
   launched the width and search kernels and the sweep's configs the
   width kernel and search, search_chain and scan, counted from zero in
   each process just before its timed passes.

The last two lines of stdout are the kernels line and
{"ok": true, "device": {...}}, printed only when phases 2-8 all ran
(``--phases`` picks a subset for debugging).  Numbers and logs also go to
chiprun_out/chip_smoke/.  Without CUDA, or outside a checkout of the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import filecmp
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parent
OUT = REPO / "chiprun_out" / "chip_smoke"

# integer operations per unit of work, counted from the kernels' inner
# loops (csrc/*_body.cuh): a width step is two single-base rank queries
# (8 words x ~7 ops + ~15 addressing each); an SW cell ~12 ops.  The
# card's peaks and the search's count are fastquick_tpu_torch/utils/
# bounds.py's, which the bench shares.
OPS_WIDTH_STEP = 150
OPS_SW_CELL = 12

# after the card phase
ALL_PHASES = ("kernels", "small", "production", "program", "pipeline",
              "mesh", "bench")

KERNELS = {
    "width": ("fastquick_tpu_torch/csrc/width.cu",
              "fastquick_tpu/ops/search_pallas.py:1603"),
    "search": ("fastquick_tpu_torch/csrc/search.cu",
               "fastquick_tpu/ops/search_pallas.py:773"),
    # the same Pallas kernel at CH > 1 (its sub-step loop, :1010-1030):
    # fq_search_chain_kernel, counted as "search_chain"
    "search_chain": ("fastquick_tpu_torch/csrc/search.cu",
                     "fastquick_tpu/ops/search_pallas.py:773"),
    "scan": ("fastquick_tpu_torch/csrc/scan.cu",
             "fastquick_tpu/ops/search_pallas.py:154"),
    "sw": ("fastquick_tpu_torch/csrc/sw.cu",
           "fastquick_tpu/ops/sw_pallas.py:52"),
    # no pallas_call: a lax.scan over the reads
    "drand48": ("fastquick_tpu_torch/csrc/drand48.cu",
                "fastquick_tpu/ops/drand48_device.py:167"),
    # no pallas_call: a lax.scan over each pair's entries (:391)
    "pairing": ("fastquick_tpu_torch/csrc/pairing.cu",
                "fastquick_tpu/ops/pe_device.py:221"),
    # no pallas_call: XLA scatter-adds inside qc_step_full (and the same
    # sums in align/device_qc.py:70 accum); fq_accum_walk, one walk of the
    # grid that also lists the pileup entries
    "accumulate": ("fastquick_tpu_torch/csrc/accumulate.cu",
                   "fastquick_tpu/ops/qc_full.py:623"),
    # no pallas_call: a scatter in read order, its ranks from
    # _pileup_ranks (:227, a stable argsort and an associative_scan);
    # fq_accum_order over the walk's entry list
    "pileup": ("fastquick_tpu_torch/csrc/accumulate.cu",
               "fastquick_tpu/ops/qc_full.py:666"),
}
# the chain-length check's step cap: low enough that some reads reach it
CHAIN_CAP = 256
# qc_step_full's search defaults: pool 256, chain 4, step cap 64 L
QC_POOL, QC_CHAIN, QC_CAP_PER_BASE = 256, 4, 64
# production reads the program phase's plain search redoes (evenly spaced)
PROGRAM_SEARCH_CHECK = 4096
# fallback rows of a production fill the Python oracle (HostEngine) redoes
# (evenly spaced; the native engine's object route takes all of them)
PROGRAM_FILL_ORACLE = 256
# the pairing kernel's shapes: qc_step_full's first pass (a batch's pairs
# at k_occ 32) and its second (ovf_cap pairs at k_occ2 512)
PAIRING_SHAPES = ((100_000, 32), (64, 512))
# the drand48 draw's production-shaped batch, and the read of it whose
# first draw the speculation-break check makes 0
DRAW_PROD_READS, DRAW_ZERO_AT = 200_000, 123_457
# the accumulation kernels' shapes: the one-program step's batch (reads x
# L over the kernels phase's text, with the production world's 10,000
# markers; some markers read deep past the pileup cap) and a
# DeviceDenseStats chunk (reads x L, uint8)
ACC_READS, ACC_L, ACC_MARKERS, ACC_FLANK, ACC_CAP = 200_000, 150, 10_000, \
    250, 64
ACC_DEEP = (50, 100)  # markers read deep, reads over each
DQC_READS, DQC_L = 4096, 150
DQC_BATCHES = 3  # DeviceDenseStats' batches on the card, a chunk each


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def cuda_ms(fn, reps: int, setup=None) -> float:
    """Mean device time of fn() in ms over `reps` runs (after a warm-up),
    by CUDA events; setup(i) runs outside the timed region."""
    import torch

    args = setup(-1) if setup else ()
    fn(*args)
    torch.cuda.synchronize()
    total = 0.0
    for i in range(reps):
        args = setup(i) if setup else ()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args)
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def _pctl(t) -> list:
    """[p50, p99, max] of an integer tensor's values."""
    import numpy as np

    v = t.cpu().numpy()
    return [float(np.percentile(v, 50)), float(np.percentile(v, 99)),
            int(v.max())]


def same_search(got, want, what: str) -> None:
    """Raise unless two searches' per-read outputs are equal."""
    import torch

    names = ("n_aln", "alns", "fb", "steps", "hwm")
    for name, a, b in zip(names, got, want):
        if not torch.equal(a, b):
            bad = (a != b).reshape(a.shape[0], -1).any(1).nonzero()[:5]
            raise AssertionError(f"{what} in {name}, reads "
                                 f"{bad.flatten().tolist()}")


# ------------------------------------------------------------- phase 1


def phase_card() -> dict:
    import torch

    from fastquick_tpu_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    build.cuda_library()
    dt = time.perf_counter() - t0
    log(f"kernels built in {dt:.1f}s ({build.build_info.get('cuda_dir')})")
    ptx = parse_ptxas(
        Path(build.build_info["cuda_dir"], "ptxas.txt").read_text())
    for name, v in ptx.items():
        log(f"ptxas {name}: {v}")
    return dict(card=card, kind=torch.cuda.get_device_name(0),
                count=torch.cuda.device_count(), build_s=dt, ptxas=ptx)


def parse_ptxas(text: str) -> dict:
    """Registers, stack frame, spill stores/loads and static shared memory
    of each fq_*_kernel from nvcc's -Xptxas -v output."""
    out: dict = {}
    cur = None
    for line in text.splitlines():
        if "entry function" in line or "Function properties for" in line:
            m = re.search(r"(?:function|for) '?\S*?(fq_\w+?_kernel)(\w*)",
                          line)
            # a template's instances apart: fq_accum_walk_kernel<1,0> ...
            t = m and re.findall(r"Lb(\d)E", m.group(2))
            cur = out.setdefault(m.group(1) + (f"<{','.join(t)}>" if t
                                               else ""), {}) if m else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_st=int(m.group(2)),
                       spill_ld=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return out


# ------------------------------------------------------------- phase 2


class _Read:
    """The two fields pack_chunk reads: length and reversed codes."""

    def __init__(self, codes):
        self.len = len(codes)
        self.seq = codes[::-1].copy()


def _draw_reads(text, n, read_len, rng):
    """Reads in the mix of tests/test_batch_engine.py: exact, 1-2
    mismatches, reverse complement, 1-base deletion, 1-base insertion,
    junk; one in twenty also gets an N."""
    import numpy as np

    out = []
    for r in range(n):
        s = int(rng.integers(0, len(text) - read_len - 1))
        codes = text[s:s + read_len].copy()
        kind = r % 6
        if kind == 1:
            for _ in range(int(rng.integers(1, 3))):
                p = int(rng.integers(0, read_len))
                codes[p] = (codes[p] + int(rng.integers(1, 4))) % 4
        elif kind == 2:
            codes = (3 - codes)[::-1].copy()
        elif kind == 3:
            mid = read_len // 2
            codes = np.concatenate([text[s:s + mid],
                                    text[s + mid + 1:s + read_len + 1]])
        elif kind == 4:
            mid = read_len // 2
            codes = np.concatenate([text[s:s + mid],
                                    rng.integers(0, 4, 1).astype(np.uint8),
                                    text[s + mid:s + read_len - 1]])
        elif kind == 5:
            codes = rng.integers(0, 4, read_len).astype(np.uint8)
        if r % 20 == 7:
            codes[int(rng.integers(0, read_len))] = 4
        out.append(codes.astype(np.uint8))
    return out


def phase_kernels(seed: int, dev: str = "cuda", text_len: int = 6_500_000,
                  M: int = 65536, n_reads: int = 4096,
                  chunk_reads: int = 32768, n_sw: int = 2048,
                  n_draw: int = 65536) -> dict:
    import dataclasses

    import numpy as np
    import torch

    from fastquick_tpu_torch.align.opts import GapOpt
    from fastquick_tpu_torch.index.fmindex import FMIndex
    from fastquick_tpu_torch.kernels import build
    from fastquick_tpu_torch.ops.batch_search import chunk_inputs, pack_chunk
    from fastquick_tpu_torch.ops.fm import DeviceFM
    from fastquick_tpu_torch.ops.search_kernels import (
        PlainLanes,
        resident_search,
        scan_chunk,
        scan_search,
        search_plain,
    )
    from fastquick_tpu_torch.testing.sw_cases import sw_edge_batch
    from fastquick_tpu_torch.testing.width_cases import (
        EDGE_LENS,
        width_edge_batch,
    )
    from fastquick_tpu_torch.utils.bounds import bound, search_bound

    dev = torch.device(dev)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    text = rng.integers(0, 4, text_len).astype(np.uint8)
    fm = DeviceFM.build(FMIndex.build(text), FMIndex.build(text[::-1].copy()),
                        dev)
    tab_bytes = fm.kernel_table().numel() * 4
    log(f"{text_len / 1e6:.1f} Mbp FM index built in "
        f"{time.perf_counter() - t0:.1f}s "
        f"(kernel table {tab_bytes / 1e6:.1f} MB)")
    res = {}

    # ---- width: M units x 160 ----
    L = 160
    units_np = np.full((M, L), 4, np.uint8)
    for m, c in enumerate(_draw_reads(text, M, 150, rng)):
        units_np[m, :len(c)] = c[:L]
    units = torch.from_numpy(units_np).to(dev)
    sel = torch.from_numpy((np.arange(M) % 2).astype(np.int32)).to(dev)
    err, ms, plain_ms = width_case(fm, units, sel, reps=5)
    bms, by = bound(M * L + 4 * M + 8 * M * L + tab_bytes,
                    M * L * OPS_WIDTH_STEP)
    res["width"] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                        bound_ms=bms, bound_by=by)
    log(f"width  M={M} L={L}: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
        f"bound {bms:.3f} ms ({by}), equal")
    for L_e in EDGE_LENS:
        u, s_ = (torch.from_numpy(a).to(dev)
                 for a in width_edge_batch(text, L_e, seed + L_e))
        width_case(fm, u, s_, reps=0)
    log(f"width  edge batches (L {'/'.join(map(str, EDGE_LENS))}, "
        f"{u.shape[0]} units: all-N, random codes, text with and without "
        f"errors, the primary row): equal")

    # ---- search: n_reads reads x 150 bp ----
    reads = [_Read(c) for c in _draw_reads(text, n_reads, 150, rng)]
    opt = GapOpt()
    packed, aux, P = pack_chunk(reads, opt, 1024)
    inp = chunk_inputs(fm, torch.from_numpy(packed).to(dev),
                       torch.from_numpy(aux).to(dev), P)
    widths0 = inp.pop("widths")
    N = packed.shape[0]
    hwm_k = torch.zeros(N, dtype=torch.int32, device=dev)
    hwm_p = torch.zeros_like(hwm_k)
    k_out = resident_search(fm, P, widths=widths0.clone(), hwm=hwm_k, **inp)
    p_out = search_plain(fm, P, widths=widths0.clone(), hwm=hwm_p, **inp)
    torch.cuda.synchronize()
    same_search((*k_out, hwm_k), (*p_out, hwm_p), "search kernel != plain")
    hwm_cell = _pctl(hwm_k[:len(reads)])
    n_fb = int((k_out[2][:len(reads)] != 0).sum())
    steps = int(k_out[3].long().sum())
    clones = [widths0.clone() for _ in range(4)]
    ms = cuda_ms(lambda w: resident_search(fm, P, widths=w, **inp), 3,
                 setup=lambda i: (clones[i + 1],))
    t0 = time.perf_counter()
    search_plain(fm, P, widths=widths0.clone(), **inp)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    # out per read: n_aln, fb, steps and the pool high-water mark
    bms, by = search_bound(P, N, tab_bytes, k_out[0], steps, 4)
    res["search"] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=0,
                         bound_ms=bms, bound_by=by, steps=steps,
                         fallback=n_fb, reads=len(reads), hwm=hwm_cell)
    log(f"search N={len(reads)} L={P.L}: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms, bound {bms:.3f} ms ({by}), {steps} steps, "
        f"{n_fb} fallback reads, equal (pool high-water marks too); "
        f"high-water mark p50/p99/max {hwm_cell}")
    chain = chain_case(fm, P, inp, widths0, len(reads))
    res["search"].update(chain.pop("cap"))
    res["search_chain"] = chain
    chain["bound_ms"], chain["bound_by"] = search_bound(
        P, N, tab_bytes, chain.pop("n_aln"), chain["steps"], 4)
    log(f"search_chain bound at pool {QC_POOL}, cap {QC_CAP_PER_BASE} L: "
        f"{chain['bound_ms']:.5f} ms ({chain['bound_by']})")

    # ---- scan: the same reads, 1024 lanes x 32 steps, pool 512, cap 768 ----
    lanes, inner = 1024, 32
    Ps = pack_chunk(reads, opt, 512, kernel="scan")[2]
    assert (Ps.NP, Ps.step_cap) == (512, 768), Ps

    def scan_run(w):
        return scan_chunk(fm, Ps, lanes, inner, widths=w, **inp)

    s_out = scan_run(widths0.clone())
    t0 = time.perf_counter()
    p_out = scan_search(fm, Ps, PlainLanes(fm, Ps, lanes,
                                           widths=widths0.clone(), **inp),
                        inner)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    r_out = resident_search(fm, Ps, widths=widths0.clone(), **inp)
    torch.cuda.synchronize()
    for ref, what in ((p_out, "its plain version"),
                      (r_out, "the resident kernel at pool 512, cap 768")):
        same_search(s_out[:4], ref[:4], f"scan kernel != {what}")
    rounds, busy = s_out[4], int(s_out[5])
    if (rounds, busy) != (p_out[4], int(p_out[5])):
        raise AssertionError(f"scan kernel took {rounds} rounds and {busy} "
                             f"busy steps, its plain version {p_out[4]} and "
                             f"{int(p_out[5])}")
    steps = int(s_out[3].long().sum())
    n_fb = int((s_out[2][:len(reads)] != 0).sum())
    clones = [widths0.clone() for _ in range(4)]
    chunk_ms = cuda_ms(scan_run, 3, setup=lambda i: (clones[i + 1],))
    # the kernel alone: CUDA events around its one launch of the chunk
    lib = build.cuda_library()
    launch = lib.fq_scan_launch
    ev = []

    def timed_launch(*args):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        rc = launch(*args)
        b.record()
        ev.append((a, b))
        return rc

    with mock.patch.object(lib, "fq_scan_launch", timed_launch):
        for w in [widths0.clone() for _ in range(3)]:
            scan_run(w)
    torch.cuda.synchronize()
    kernel_ms = [a.elapsed_time(b) for a, b in ev]
    ms = sum(kernel_ms) / len(kernel_ms)
    # out per read: n_aln, fb, steps
    bms, by = search_bound(Ps, N, tab_bytes, s_out[0], steps, 3)
    res["scan"] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=0,
                       bound_ms=bms, bound_by=by, steps=steps,
                       fallback=n_fb, reads=len(reads), rounds=rounds,
                       chunk_ms=chunk_ms, lanes=lanes, inner=inner,
                       busy=busy, launch_ms=kernel_ms)
    log(f"scan   N={len(reads)} {lanes} lanes x {inner} steps, pool 512, "
        f"cap 768: {rounds} rounds, {busy} busy steps in one launch; kernel "
        f"{ms:.3f} ms (runs {', '.join(f'{x:.3f}' for x in kernel_ms)}), "
        f"whole chunk {chunk_ms:.3f} ms, plain path {plain_ms:.1f} ms, bound "
        f"{bms:.5f} ms ({by}), {steps} steps, {n_fb} fallback reads; equal "
        f"to its plain version and to the resident kernel at the same pool "
        f"and cap")
    del clones

    # the kernel alone at one full main-path chunk (BatchEngine.max_batch
    # reads); its plain version would take minutes here
    reads = [_Read(c) for c in _draw_reads(text, chunk_reads, 150, rng)]
    packed, aux, P = pack_chunk(reads, opt, 1024)
    inp = chunk_inputs(fm, torch.from_numpy(packed).to(dev),
                       torch.from_numpy(aux).to(dev), P)
    widths0 = inp.pop("widths")
    clones = [widths0.clone() for _ in range(4)]
    hwm_k = torch.zeros(packed.shape[0], dtype=torch.int32, device=dev)
    out = resident_search(fm, P, widths=clones[0], hwm=hwm_k, **inp)
    steps = int(out[3].long().sum())
    longest = int(out[3].max())
    ms = cuda_ms(lambda w: resident_search(fm, P, widths=w, **inp), 3,
                 setup=lambda i: (clones[i + 1],))
    hwm_chunk = _pctl(hwm_k[:chunk_reads])
    res["search"].update(chunk_reads=chunk_reads, chunk_ms=ms,
                         chunk_steps=steps, chunk_max_steps=longest,
                         step_us=1e3 * ms / longest, chunk_hwm=hwm_chunk)
    log(f"search N={chunk_reads} (one chunk): kernel {ms:.3f} ms, {steps} "
        f"steps, longest read {longest} steps, {1e3 * ms / longest:.3f} "
        f"us a step of it; high-water mark p50/p99/max {hwm_chunk}")
    del inp, widths0, clones, out

    # ---- SW: n_sw jobs, RL = 640, QL = 128 ----
    B, RL, QL = n_sw, 640, 128
    refs = rng.integers(0, 4, (B, RL)).astype(np.uint8)
    qs = rng.integers(0, 4, (B, QL)).astype(np.uint8)
    rl = rng.integers(560, RL + 1, B).astype(np.int32)
    ql = rng.integers(96, QL + 1, B).astype(np.int32)
    for b in range(0, B, 2):  # planted local matches with a few errors
        s = int(rng.integers(0, rl[b] - ql[b]))
        q = refs[b, s:s + ql[b]].copy()
        for _ in range(int(rng.integers(0, 5))):
            q[int(rng.integers(0, ql[b]))] = int(rng.integers(0, 5))
        qs[b, :ql[b]] = q
    args = [torch.from_numpy(a).to(dev) for a in (refs, qs, rl, ql)]
    o_k, err, ms, plain_ms = sw_case(args)
    cells = int((rl.astype(np.int64) * ql).sum())
    bms, by = bound(B * (RL + QL) + 8 * B + 16 * B, cells * OPS_SW_CELL)
    res["sw"] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                     bound_ms=bms, bound_by=by, cells=cells,
                     planted_best=float(o_k[0::2, 0].float().mean()))
    log(f"sw     B={B} {RL}x{QL}: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms, bound {bms:.3f} ms ({by}), equal")
    edge = [torch.from_numpy(a).to(dev) for a in sw_edge_batch(seed)]
    sw_case(edge, reps=0)
    res["sw"]["edge_jobs"] = int(edge[0].shape[0])
    log(f"sw     edge batch ({edge[0].shape[0]} jobs: ql 1-150 around the "
        f"strip of 32, rl 0/1/640, all-N, tied maxima): equal")
    res["drand48"] = drand48_case(dev, rng, n_draw)
    pairs = [pairing_case(dev, rng, P, K) for P, K in PAIRING_SHAPES]
    res["pairing"] = dict(pairs[0], second_pass=pairs[1])
    res.update(accumulate_case(dev, rng, text))
    build.reset_launch_counts()
    return res


def chain_case(fm, P, inp, widths0, n: int) -> dict:
    """The resident kernel at chain length 4 against its plain version, in
    hits, fallback bits, steps and pool high-water marks: at a step cap
    that binds (CHAIN_CAP), with its fallback set against chain 1's and
    both chain lengths timed by CUDA events; and at qc_step_full's own
    settings (pool 256, step cap 64 L), where most reads overflow the pool.
    Returns the second check's entry of the kernels line, with the cap
    check's numbers under "cap" and the hit counts under "n_aln"."""
    import dataclasses

    import torch

    from fastquick_tpu_torch.ops.search_kernels import (
        FB_POOL,
        resident_search,
        search_plain,
    )
    from fastquick_tpu_torch.utils.bounds import search_bound

    def check(Pc, what):
        hwm_k = torch.zeros(widths0.shape[0] // 2, dtype=torch.int32,
                            device=widths0.device)
        hwm_p = torch.zeros_like(hwm_k)
        k = resident_search(fm, Pc, widths=widths0.clone(), hwm=hwm_k, **inp)
        t0 = time.perf_counter()
        p = search_plain(fm, Pc, widths=widths0.clone(), hwm=hwm_p, **inp)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        same_search((*k, hwm_k), (*p, hwm_p),
                    f"search kernel at chain 4, {what}, != plain")
        return k, plain_ms

    def timed(Pc):
        clones = [widths0.clone() for _ in range(4)]
        return cuda_ms(lambda w: resident_search(fm, Pc, widths=w, **inp), 3,
                       setup=lambda i: (clones[i + 1],))

    P1 = dataclasses.replace(P, step_cap=CHAIN_CAP)
    P4 = dataclasses.replace(P1, CH=4)
    k4, plain_ms = check(P4, f"step cap {CHAIN_CAP}")
    k1 = resident_search(fm, P1, widths=widths0.clone(), **inp)
    fb1, fb4 = k1[2][:n] != 0, k4[2][:n] != 0
    if torch.equal(fb1, fb4):
        raise AssertionError(f"step cap {CHAIN_CAP} does not bind: chain 1 "
                             "and 4 fall back on the same reads")
    both = ~fb1 & ~fb4
    if not (torch.equal(k1[0][:n][both], k4[0][:n][both])
            and torch.equal(k1[1][:n][both], k4[1][:n][both])):
        raise AssertionError("chain 1 and 4 differ in the hits of reads "
                             "both finish")
    cap = {f"chain{ch}_ms": timed(Pc) for ch, Pc in ((1, P1), (4, P4))}
    cap.update(chain_cap=CHAIN_CAP, chain4_plain_ms=plain_ms,
               chain1_steps=int(k1[3].long().sum()),
               chain4_steps=int(k4[3].long().sum()),
               chain1_fallback=int(fb1.sum()), chain4_fallback=int(fb4.sum()),
               chain1_max_steps=int(k1[3].max()),
               chain4_max_steps=int(k4[3].max()))
    log(f"search N={n} at step cap {CHAIN_CAP}: chain 4 kernel "
        f"{cap['chain4_ms']:.3f} ms (plain {plain_ms:.1f} ms), equal (pool "
        f"high-water marks too); chain 1 {cap['chain1_ms']:.3f} ms; steps "
        f"{cap['chain4_steps']} vs {cap['chain1_steps']} (longest read "
        f"{cap['chain4_max_steps']} vs {cap['chain1_max_steps']}), fallback "
        f"reads {cap['chain4_fallback']} vs {cap['chain1_fallback']}, hits of "
        f"the reads both finish equal")

    Pq = dataclasses.replace(P, NP=QC_POOL, step_cap=QC_CAP_PER_BASE * P.L,
                             CH=QC_CHAIN)
    kq, plain_ms = check(Pq, f"pool {QC_POOL}, step cap {Pq.step_cap}")
    fb = kq[2][:n]
    n_pool = int(((fb & FB_POOL) != 0).sum())
    if not n_pool:
        raise AssertionError(f"pool {QC_POOL}: no read overflowed it")
    out = dict(ms=timed(Pq), plain_ms=plain_ms, max_abs_err=0, reads=n,
               pool=QC_POOL, step_cap=Pq.step_cap, chain=QC_CHAIN,
               steps=int(kq[3].long().sum()), max_steps=int(kq[3].max()),
               fallback=int((fb != 0).sum()), pool_fallback=n_pool,
               finished=int((fb == 0).sum()), cap=cap, n_aln=kq[0])
    log(f"search N={n} at qc_step_full's pool {QC_POOL}, chain {QC_CHAIN}, "
        f"step cap {Pq.step_cap}: kernel {out['ms']:.3f} ms, plain "
        f"{plain_ms:.1f} ms, equal (pool high-water marks too); "
        f"{out['steps']} steps (longest read {out['max_steps']}), "
        f"{out['fallback']} fallback reads ({n_pool} pool overflows), "
        f"{out['finished']} finished")
    return out


def same_draw(got, want, what: str) -> None:
    """Raise unless two draws agree in words, rows and final state."""
    import torch

    for name, a, b in zip(("f0", "row", "state"), got, want):
        if not torch.equal(a, b):
            bad = (a != b).nonzero()[:5].flatten().tolist()
            raise AssertionError(f"{what} in {name}, at {bad}")


def _draw_check(dev, n_aln, alns, state, what: str,
                zero_at: int | None = None) -> dict:
    """One batch through the drand48 kernel and its plain version (equal
    in words, rows and final state), the kernel timed by CUDA events;
    zero_at: a read that must select nothing (its first draw is 0)."""
    import torch

    from fastquick_tpu_torch.ops.drand48_device import (
        aln2seq_draw_scan,
        best_class,
        draw_scan_plain,
    )
    from fastquick_tpu_torch.utils.bounds import OPS_DRAW, bound

    na = torch.from_numpy(n_aln).to(dev)
    al = torch.from_numpy(alns).to(dev)
    st = torch.from_numpy(state).to(dev)
    k_out = aln2seq_draw_scan(na, al, st)
    walk: dict = {}
    t0 = time.perf_counter()
    p_out = draw_scan_plain(na, al, st, stats=walk)
    plain_ms = (time.perf_counter() - t0) * 1e3
    same_draw(k_out, p_out, f"drand48 kernel != plain ({what})")
    if zero_at is not None and (int(p_out[0][zero_at])
                                or int(p_out[1][zero_at])):
        raise AssertionError(f"drand48 ({what}): read {zero_at} selected a "
                             "row: its first draw was not 0")
    ms = cuda_ms(lambda: aln2seq_draw_scan(na, al, st), 3)
    nb = best_class(na, al)
    rows, draws, n = int(nb.sum()), walk["draws"], len(n_aln)
    # 12 bytes a read (n_aln in, the selected word and row out) and each
    # best-class row read once; ~10 dependent operations a draw
    bms, by = bound(12 * n + 12 * rows, draws * OPS_DRAW)
    out = dict(ms=ms, plain_ms=plain_ms, max_abs_err=0, bound_ms=bms,
               bound_by=by, reads=n, rows=rows, draws=draws,
               single=int((nb == 1).sum()), multi=int((nb > 1).sum()))
    log(f"drand48 N={n} ({what}): kernel {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms, bound {bms:.5f} ms ({by}), {rows} best-class "
        f"rows, {out['single']} single-row and {out['multi']} multi-row "
        f"reads, {draws} draws; equal in words, rows and final state")
    return out


def drand48_case(dev, rng, n: int) -> dict:
    """The drand48 kernel against its plain version on n reads of random
    hit lists (the kernels line's numbers), on a production-shaped batch
    (mostly single-row reads) and on that batch from the state whose
    first draw at read DRAW_ZERO_AT is 0, which breaks the kernel's
    speculation there (it and the reads before it are made single-row, so
    the state is known)."""
    from fastquick_tpu_torch.ops.drand48_device import seed_state
    from fastquick_tpu_torch.testing.drand48_cases import (
        production_batch,
        random_batch,
        zero_draw_state,
    )

    n_aln, alns, _ = random_batch(rng, n)
    res = _draw_check(dev, n_aln, alns, seed_state(11), "random hit lists")
    n_aln, alns = production_batch(rng, DRAW_PROD_READS)
    res["production"] = _draw_check(dev, n_aln, alns, seed_state(11),
                                    "production-shaped")
    n_aln[:DRAW_ZERO_AT + 1] = 1
    alns[:DRAW_ZERO_AT + 1, 1:] = 0
    res["zero_draw"] = _draw_check(
        dev, n_aln, alns, zero_draw_state(2 * DRAW_ZERO_AT),
        f"a first draw of 0 at read {DRAW_ZERO_AT}", DRAW_ZERO_AT)
    return res


def pairing_case(dev, rng, P: int, K: int) -> dict:
    """The pairing kernel against pairing_sweep_plain on P pairs at
    occurrence cap K (testing/pairing_cases.py): every output field and
    cnt_chg equal; the kernel's one launch timed by CUDA events around it,
    the wrapper whole (with its penalty table) and the plain version by
    events too."""
    import torch

    from fastquick_tpu_torch.align.opts import G_LOG_N
    from fastquick_tpu_torch.kernels import build
    from fastquick_tpu_torch.ops.pe_device import (
        pairing_sweep,
        pairing_sweep_plain,
        pairing_work,
        penalty_table,
    )
    from fastquick_tpu_torch.testing.pairing_cases import (
        random_pairs,
        same_sweep,
    )
    from fastquick_tpu_torch.utils.bounds import pairing_bound

    occ0, occ1, a0, a1, se0, se1, ok, ii = random_pairs(rng, P, K)

    def t(x):
        return torch.from_numpy(x).to(dev)

    def d(x):
        return {k: t(v) for k, v in x.items()}

    args = (d(occ0), d(occ1), t(a0), t(a1), d(se0), d(se1), t(ok), t(ii),
            3, 500, torch.tensor(G_LOG_N, dtype=torch.long, device=dev))
    build.reset_launch_counts()
    got = pairing_sweep(*args)
    if build.launch_counts["pairing"] != 1:
        raise AssertionError(f"pairing_sweep at P={P} K={K}: "
                             f"{build.launch_counts['pairing']} launches")
    same_sweep(got, pairing_sweep_plain(*args),
               f"pairing kernel != plain at P={P} K={K}")
    runs = _launches_ms(lambda: pairing_sweep(*args),
                        {"sweep": "fq_pairing_launch"})["sweep"]
    ms = sum(runs) / len(runs)
    wrapper_ms = cuda_ms(lambda: pairing_sweep(*args), 3)
    table_ms = cuda_ms(lambda: penalty_table(args[7]), 3)
    plain_ms = cuda_ms(lambda: pairing_sweep_plain(*args), 1)
    work = pairing_work(*args[:4], args[6], args[7])
    n_valid, n_rev, n_words, pen_len = (int(work[k]) for k in (
        "valid", "reverse", "words", "penalty_len"))
    n_cmp = float(work["compares"])
    bms, by = pairing_bound(P, n_valid, n_rev, n_words, n_cmp, pen_len)
    out = dict(ms=ms, wrapper_ms=wrapper_ms, table_ms=table_ms,
               plain_ms=plain_ms,
               max_abs_err=0, bound_ms=bms, bound_by=by, pairs=P, k_occ=K,
               entries=n_valid, reverse=n_rev, words=n_words, compares=n_cmp,
               cnt_chg=int(got[2]), proper=int(got[0]["proper"].sum()))
    log(f"pairing P={P} K={K}: kernel {ms:.4f} ms (runs "
        f"{', '.join(f'{x:.4f}' for x in runs)}), pairing_sweep with its "
        f"penalty table {wrapper_ms:.4f} ms (the table alone "
        f"{table_ms:.4f} ms), plain {plain_ms:.1f} ms, bound "
        f"{bms:.5f} ms ({by}); {n_valid} entries, {n_rev} reverse, "
        f"{n_words} words, {n_cmp:.0f} compares, {out['proper']} proper "
        f"pairs, cnt_chg {out['cnt_chg']}; one launch, every output equal")
    return out


def _marker_bases(tables, n_text: int, t: dict) -> tuple[int, int]:
    """(covered bases at a marker's pac position, reads with a pileup
    entry) of a qc case's tensors: the counts pileup_bound takes."""
    import torch

    L = t["seqs"].shape[1]
    offs = torch.arange(L, device=t["pos"].device)[None]
    cover = t["eligible"][:, None] & (offs < t["lens"][:, None])
    pac = (t["pos"][:, None] + offs).clamp(0, n_text)
    on_mk = cover & (tables.marker_id[pac] >= 0)
    entry = on_mk & (tables.site_idx[pac] >= 0)
    return int(on_mk.sum()), int(entry.any(1).sum())


# the accumulation's C launches, by the names _launches_ms gives them
ACC_LAUNCHES = {"walk": "fq_accum_walk_launch",
                "order": "fq_accum_order_launch"}


def _launches_ms(fn, names: dict = ACC_LAUNCHES, reps: int = 3,
                 warmup: bool = True) -> dict:
    """The device times (ms) of the C launches of the library that fn()
    makes, by CUDA events around each, over reps runs (after a warm-up):
    for each name of `names` (name -> launch function) each run's time,
    summed over its launches of that kind ([] if none), and "span" (from
    the first launch's start to the last one's end)."""
    import torch

    from fastquick_tpu_torch.kernels import build

    lib = build.cuda_library()
    runs: list = []

    def timed(kind, launch):
        def run(*a):
            e = (torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True))
            e[0].record()
            rc = launch(*a)
            e[1].record()
            runs[-1].append((kind, e))
            return rc
        return run

    with contextlib.ExitStack() as stack:
        for kind, name in names.items():
            stack.enter_context(mock.patch.object(
                lib, name, timed(kind, getattr(lib, name))))
        for _ in range(reps + warmup):
            runs.append([])
            fn()
    torch.cuda.synchronize()
    out: dict = {k: [] for k in names}
    out["span"] = []
    for run in runs[warmup:]:
        for kind in names:
            ms = [a.elapsed_time(b) for k, (a, b) in run if k == kind]
            if ms:
                out[kind].append(sum(ms))
        out["span"].append(run[0][1][0].elapsed_time(run[-1][1][1]))
    return out


def _mean(x: list) -> float:
    return sum(x) / len(x)


def _device_stats_run(dev, rng, text, mpos, tables) -> dict:
    """align --device_qc's DeviceDenseStats on the card over DQC_BATCHES
    batches of reads (ref_case, DQC_L), each flush deferred as the driver
    defers it at a batch end, then one drain: the collector's arrays equal
    to the plain sums of every chunk, DQC_BATCHES chunks walked into the
    resident sums, one copy to the host; each chunk's walk timed by CUDA
    events around it."""
    import numpy as np
    import torch
    from types import SimpleNamespace

    from fastquick_tpu_torch.align import device_qc
    from fastquick_tpu_torch.kernels import build
    from fastquick_tpu_torch.ops import accumulate as acc
    from fastquick_tpu_torch.testing import accumulate_cases as ac
    from tools.dense_flush_probe import timed_flush

    S = tables.n_sites
    coll = SimpleNamespace(
        sites=SimpleNamespace(**{k: np.zeros(S, np.int64)
                                 for k in ("depth", "q20", "q30")}),
        **{k: np.zeros(256, np.int64) for k in (
            "emp_rep_dist", "emp_cycle_dist", "mis_emp_rep_dist",
            "mis_emp_cycle_dist")})
    want = torch.zeros(acc.dense_size(S), dtype=torch.int64, device=dev)
    with mock.patch.object(device_qc, "build_site_tables",
                           lambda *a: tables):
        stats = device_qc.DeviceDenseStats(
            SimpleNamespace(l_pac=len(text)), None, None, dev)
    coll.dense_device = stats
    coll.flush_dense = lambda: stats.flush(coll)
    deferred: dict = {}
    drain: dict = {}
    build.reset_launch_counts()
    walks = []
    with timed_flush(device_qc, deferred):
        for _ in range(DQC_BATCHES):
            c = ac.ref_case(rng, text, mpos, DQC_READS, DQC_L, wrap=0.01)
            for r in range(DQC_READS):
                ln = int(c["lens"][r])
                codes, chars = c["codes"][r, :ln], c["quals"][r, :ln] + 33
                if c["strand"][r]:
                    codes = np.where(codes < 4, 3 - codes, 4)[::-1]
                    chars = chars[::-1]
                stats.add(SimpleNamespace(
                    pos=int(c["pos"][r]), strand=int(c["strand"][r]),
                    len=ln, seq=codes.astype(np.uint8),
                    qual=chars.astype(np.uint8)))
            t = {k: torch.from_numpy(np.asarray(v)).to(dev)
                 for k, v in c.items()}
            want += acc.pack_dense_plain(acc.dense_accumulate_plain(
                tables, len(text), t["pos"], t["strand"], t["codes"],
                t["quals"], t["lens"]), S)
            walks += _launches_ms(lambda: device_qc.flush_batch(coll),
                                  reps=1, warmup=False)["walk"]
    if deferred["copies"] or any(a.any() for a in (coll.sites.depth,
                                                   coll.emp_rep_dist)):
        raise AssertionError("DeviceDenseStats drained inside a deferred "
                             "flush")
    with timed_flush(device_qc, drain):
        coll.flush_dense()
    got = acc.unpack_dense(want.cpu().numpy(), S)
    for name, arr in (("depth", coll.sites.depth), ("q20", coll.sites.q20),
                      ("q30", coll.sites.q30),
                      ("emp_rep", coll.emp_rep_dist),
                      ("emp_cycle", coll.emp_cycle_dist),
                      ("mis_emp_rep", coll.mis_emp_rep_dist),
                      ("mis_emp_cycle", coll.mis_emp_cycle_dist)):
        if not np.array_equal(arr, got[name]):
            raise AssertionError(f"DeviceDenseStats on the card: {name} != "
                                 "the plain sums of its chunks")
    if (stats.drains, drain["copies"], build.launch_counts["accumulate"]) \
            != (1, 1, DQC_BATCHES):
        raise AssertionError(f"DeviceDenseStats on the card: {stats.drains} "
                             f"drains, {drain['copies']} copies, launches "
                             f"{build.launch_counts}")
    out = dict(batches=DQC_BATCHES, walk_ms=walks,
               deferred_flush_s=deferred["flush_s"], drain_s=drain["flush_s"],
               bytes_to_host=drain["bytes_to_host"], sites=S)
    log(f"DeviceDenseStats on the card: {DQC_BATCHES} batches of "
        f"{DQC_READS} x {DQC_L}, each flush deferred (a walk into the "
        f"resident sums: {', '.join(f'{x:.4f}' for x in walks)} ms; "
        f"{deferred['flush_s']:.4f}s inside them, host clock, no copy), "
        f"then one drain ({drain['flush_s']:.4f}s, "
        f"{drain['bytes_to_host']} bytes to the host): the collector's "
        "arrays equal to the plain sums of every chunk")
    return out


def accumulate_case(dev, rng, text) -> dict:
    """The accumulation kernels against their plain versions: ACC_READS
    production-shaped reads x ACC_L over `text` with ACC_MARKERS markers
    (testing/accumulate_cases.qc_case: both strands, ragged, some past the
    text's end, ACC_DEEP reads over a few markers past the cap), the
    one-program step's one walk and order (accumulate_pileup) without and
    with random slot offsets, the dense sums alone (accumulate) and the
    pileups alone (pileup, its walk reading the marker word first); then a
    DeviceDenseStats chunk of DQC_READS x DQC_L (uint8, quality characters
    that wrap) into fresh and into resident sums, and DeviceDenseStats
    itself over DQC_BATCHES deferred flushes and one drain.  Every output
    equal; each launch timed by CUDA events around it, the wrappers and
    the plain versions (the torch ops the kernels replace) too; the
    bounds from this run's inputs."""
    import numpy as np
    import torch

    from fastquick_tpu_torch.kernels import build
    from fastquick_tpu_torch.ops import accumulate as acc
    from fastquick_tpu_torch.ops.qc_full import synthetic_site_tables
    from fastquick_tpu_torch.testing import accumulate_cases as ac
    from fastquick_tpu_torch.utils.bounds import (
        accumulate_bound,
        pileup_bound,
        walk_bound,
    )

    def put(case):
        return {k: None if v is None else torch.from_numpy(
            np.asarray(v)).to(dev) for k, v in case.items()
            if k != "pileup_cap"}

    def step_plain(tab, n, planes, mapq, cap, mb):
        return acc.step_outputs(acc.accumulate_plain(tab, n, *planes),
                                 acc.pileup_plain(tab, n, *planes, mapq,
                                                  cap, mb))

    # all_markers: "mixed" with a marker at every site, so that a walk
    # block lists more entries than its shared buffer holds
    for name in (*ac.QC_EDGE, "marker_at_zero", "all_markers"):
        base = "mixed" if name == "all_markers" else name
        spec, etext, case = ac.edge_case(base)
        tab = ac.edge_tables(base, spec, etext, dev)
        if name == "all_markers":
            ac.mark_every_site(tab)
        t = put(case)
        ep = [t[k] for k in ("seqs", "rseqs", "quals", "lens", "eligible",
                             "pos", "strand")]
        tail = (t["mapq"], case["pileup_cap"], t["marker_base"])
        ac.same_outputs(acc.accumulate_pileup(tab, len(etext), *ep, *tail),
                        step_plain(tab, len(etext), ep, *tail),
                        f"accumulate_pileup kernels != plain ({name})")
        ac.same_outputs(acc.accumulate(tab, len(etext), *ep),
                        acc.accumulate_plain(tab, len(etext), *ep),
                        f"accumulate kernel != plain ({name})")
        ac.same_outputs(acc.pileup(tab, len(etext), *ep, *tail),
                        acc.pileup_plain(tab, len(etext), *ep, *tail),
                        f"pileup kernels != plain ({name})")
    for name in ac.REF_EDGE:
        spec, etext, case = ac.edge_case(name, ref=True)
        tab = ac.edge_tables(name, spec, etext, dev)
        t = put(case)
        args = (tab, len(etext), t["pos"], t["strand"], t["codes"],
                t["quals"], t["lens"])
        want = acc.pack_dense_plain(acc.dense_accumulate_plain(*args),
                                    tab.n_sites)
        sums = acc.dense_accumulate(*args)
        if not torch.equal(sums, want) or not torch.equal(
                acc.dense_accumulate(*args, out=sums), 2 * want):
            raise AssertionError(f"dense walk != plain ({name})")
    log(f"accumulate edge cases ({', '.join(ac.QC_EDGE)}, marker_at_zero, "
        f"all_markers; "
        f"DeviceDenseStats {', '.join(ac.REF_EDGE)}, fresh and resident "
        "sums): the walk and order kernels equal to plain in every mode")

    t0 = time.perf_counter()
    n_text = len(text)
    tables = synthetic_site_tables(text, ACC_MARKERS, ACC_FLANK, device=dev)
    mpos = np.linspace(ACC_FLANK, n_text - ACC_FLANK - 1,
                       ACC_MARKERS).astype(np.int64)
    case = ac.qc_case(rng, text, mpos, ACC_READS, ACC_L,
                      deep_markers=ACC_DEEP[0], deep_reads=ACC_DEEP[1],
                      pileup_cap=ACC_CAP, marker_base=True)
    t = put(case)
    planes = [t[k] for k in ("seqs", "rseqs", "quals", "lens", "eligible",
                             "pos", "strand")]
    mapq, mb = t["mapq"], t["marker_base"]
    S, M = tables.n_sites, tables.n_markers
    log(f"accumulate case: {ACC_READS} reads x {ACC_L} over {n_text / 1e6:.1f}"
        f" Mbp, {M} markers, {S} sites; made in "
        f"{time.perf_counter() - t0:.1f}s")

    build.reset_launch_counts()
    steps = {}
    for what, base in (("no offsets", None), ("slot offsets", mb)):
        got = acc.accumulate_pileup(tables, n_text, *planes, mapq, ACC_CAP,
                                    base)
        steps[what] = step_plain(tables, n_text, planes, mapq, ACC_CAP, base)
        ac.same_outputs(got, steps[what],
                        f"accumulate_pileup kernels != plain ({what})")
    if (build.launch_counts["accumulate"], build.launch_counts["pileup"]) \
            != (2, 2):
        raise AssertionError(f"accumulate_pileup launched "
                             f"{build.launch_counts}: not one walk and one "
                             "order a call")
    ac.same_outputs(acc.accumulate(tables, n_text, *planes),
                    acc.accumulate_plain(tables, n_text, *planes),
                    "accumulate kernel != plain")
    for what, base in (("no offsets", None), ("slot offsets", mb)):
        ac.same_outputs(acc.pileup(tables, n_text, *planes, mapq, ACC_CAP,
                                   base),
                        acc.pileup_plain(tables, n_text, *planes, mapq,
                                         ACC_CAP, base),
                        f"pileup kernels != plain ({what})")

    def step():
        return acc.accumulate_pileup(tables, n_text, *planes, mapq, ACC_CAP,
                                     None)

    def dense():
        return acc.accumulate(tables, n_text, *planes)

    def pile():
        return acc.pileup(tables, n_text, *planes, mapq, ACC_CAP, None)

    t_step, t_dense, t_pile = (_launches_ms(f) for f in (step, dense,
                                                              pile))
    want = steps["no offsets"]
    lens = t["lens"].clamp(0, ACC_L)
    n_cover = int(torch.where(t["eligible"], lens, 0).sum())
    n_reg = int(want["n_base_mapped"])
    n_entries = int(want["pileup_cnt"].long().sum())
    n_on_marker, n_entry_reads = _marker_bases(tables, n_text, t)
    counts = dict(reads=ACC_READS, L=ACC_L, covered=n_cover, in_region=n_reg,
                  entries=n_entries, on_marker=n_on_marker,
                  entry_reads=n_entry_reads, sites=S,
                  deepest=int(want["pileup_cnt"].max()),
                  overflow={k: int(v["pileup_ovf"]) for k, v in steps.items()})
    res = {}
    bms, by = walk_bound(ACC_READS, n_cover, n_reg, n_entry_reads, S, M,
                         ACC_CAP, 4, 25)
    res["accumulate"] = dict(
        ms=_mean(t_step["span"]), runs=t_step["span"], walk=t_step["walk"],
        order=t_step["order"], wrapper_ms=cuda_ms(step, 3), max_abs_err=0,
        plain_ms=cuda_ms(lambda: step_plain(tables, n_text, planes, mapq,
                                            ACC_CAP, None), 1),
        bound_ms=bms, bound_by=by, **counts)
    bms, by = accumulate_bound(ACC_READS, n_cover, n_reg, S, 4, 25)
    res["accumulate"]["dense_only"] = dict(
        ms=_mean(t_dense["walk"]), runs=t_dense["walk"],
        plain_ms=cuda_ms(lambda: acc.accumulate_plain(tables, n_text,
                                                       *planes), 1),
        bound_ms=bms, bound_by=by)
    bms, by = pileup_bound(ACC_READS, n_cover, n_on_marker, n_entries,
                           n_entry_reads, M, ACC_CAP, 4)
    res["pileup"] = dict(
        ms=_mean(t_pile["span"]), runs=t_pile["span"], walk=t_pile["walk"],
        order=t_pile["order"], wrapper_ms=cuda_ms(pile, 3), max_abs_err=0,
        plain_ms=cuda_ms(lambda: acc.pileup_plain(
            tables, n_text, *planes, mapq, ACC_CAP, None), 1),
        bound_ms=bms, bound_by=by, **counts)

    def runs(x):
        return ", ".join(f"{v:.4f}" for v in x)

    r = res["accumulate"]
    log(f"accumulate N={ACC_READS} L={ACC_L} (accumulate_pileup: one walk "
        f"and one order launch): {r['ms']:.4f} ms from the walk's start to "
        f"the order's end (runs {runs(r['runs'])}; walk "
        f"{runs(r['walk'])}, order {runs(r['order'])}), wrapper "
        f"{r['wrapper_ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
        f"{r['bound_ms']:.5f} ms ({r['bound_by']}); equal")
    d = r["dense_only"]
    log(f"accumulate N={ACC_READS} L={ACC_L} (accumulate: the walk's dense "
        f"sums alone): {d['ms']:.4f} ms (runs {runs(d['runs'])}), plain "
        f"{d['plain_ms']:.3f} ms, bound {d['bound_ms']:.5f} ms "
        f"({d['bound_by']}); equal")
    p = res["pileup"]
    log(f"pileup N={ACC_READS} L={ACC_L} (pileup: the walk's entries alone "
        f"and the order): {p['ms']:.4f} ms (runs {runs(p['runs'])}; walk "
        f"{runs(p['walk'])}, order {runs(p['order'])}), wrapper "
        f"{p['wrapper_ms']:.4f} ms, plain {p['plain_ms']:.3f} ms, bound "
        f"{p['bound_ms']:.5f} ms ({p['bound_by']}); equal")
    log(f"accumulate case: {n_cover} covered bases, {n_reg} in regions, "
        f"{n_on_marker} at a marker; {n_entries} pileup entries from "
        f"{n_entry_reads} reads, deepest marker {counts['deepest']}, past "
        f"the cap {counts['overflow']}; every output equal")

    # a DeviceDenseStats chunk: uint8 planes in reference orientation
    rc = ac.ref_case(rng, text, mpos, DQC_READS, DQC_L, wrap=0.01)
    r = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in rc.items()}
    args = (tables, n_text, r["pos"], r["strand"], r["codes"], r["quals"],
            r["lens"])
    want = acc.pack_dense_plain(acc.dense_accumulate_plain(*args), S)
    got = acc.dense_accumulate(*args)
    if not torch.equal(got, want):
        bad = (got != want).nonzero()[:5].flatten().tolist()
        raise AssertionError(f"dense walk != plain (DeviceDenseStats "
                             f"chunk) at {bad}")
    sums = torch.zeros_like(got)
    q_res = _launches_ms(lambda: acc.dense_accumulate(*args, out=sums))
    q_new = _launches_ms(lambda: acc.dense_accumulate(*args))
    n_cover = int(r["lens"].clamp(0, DQC_L).sum())
    n_reg = int(acc.unpack_dense(want, S)["n_base_mapped"])
    bms, by = accumulate_bound(DQC_READS, n_cover, n_reg, S, 1, 24,
                               output=False)
    old_bms, _ = accumulate_bound(DQC_READS, n_cover, n_reg, S, 1, 24)
    res["accumulate"]["device_qc"] = dq = dict(
        ms=_mean(q_res["walk"]), runs=q_res["walk"],
        fresh_ms=_mean(q_new["walk"]),
        wrapper_ms=cuda_ms(lambda: acc.dense_accumulate(*args, out=sums), 3),
        plain_ms=cuda_ms(lambda: acc.dense_accumulate_plain(*args), 1),
        bound_ms=bms, bound_by=by, bound_with_output_ms=old_bms,
        reads=DQC_READS, L=DQC_L, covered=n_cover, in_region=n_reg)
    log(f"accumulate N={DQC_READS} L={DQC_L} (DeviceDenseStats chunk, "
        f"uint8): the walk into resident sums {dq['ms']:.4f} ms (runs "
        f"{runs(dq['runs'])}), into fresh sums (zeroed: the launch's "
        f"memset) {dq['fresh_ms']:.4f} ms, wrapper {dq['wrapper_ms']:.4f} "
        f"ms, plain {dq['plain_ms']:.3f} ms, bound {bms:.5f} ms ({by}; with "
        f"the output {old_bms:.5f}); equal")
    res["accumulate"]["device_stats"] = _device_stats_run(dev, rng, text,
                                                          mpos, tables)
    return res


def width_case(fm, units, sel, reps: int = 3):
    """The width kernel against its plain version on one batch (raises if
    they differ); returns (max abs err 0, kernel ms, plain ms), the times
    by CUDA events over `reps` runs (none if 0)."""
    import torch

    from fastquick_tpu_torch.ops.fm import cal_width_planes
    from fastquick_tpu_torch.ops.search_kernels import width

    w_k, b_k = width(fm, units, sel)
    w_p, b_p = cal_width_planes(fm, sel, units)
    torch.cuda.synchronize()
    err = max(int((w_k - w_p).abs().max()), int((b_k - b_p).abs().max()))
    if err:
        bad = ((w_k != w_p) | (b_k != b_p)).any(1).nonzero()[:5]
        raise AssertionError(f"width kernel != plain at {tuple(units.shape)}"
                             f" (max abs err {err}, units "
                             f"{bad.flatten().tolist()})")
    if not reps:
        return err, None, None
    ms = cuda_ms(lambda: width(fm, units, sel), reps)
    plain_ms = cuda_ms(lambda: cal_width_planes(fm, sel, units), 1)
    return err, ms, plain_ms


def sw_case(args, reps: int = 3):
    """The SW kernel against its plain version on one batch (raises if
    they differ); returns (kernel output, max abs err 0, kernel ms, plain
    ms), the times by CUDA events over `reps` runs (none if 0)."""
    import torch

    from fastquick_tpu_torch.ops.sw_kernels import (
        sw_forward_batch,
        sw_forward_plain,
    )

    o_k = sw_forward_batch(*args)
    o_p = sw_forward_plain(*args)
    torch.cuda.synchronize()
    err = int((o_k - o_p).abs().max()) if o_k.numel() else 0
    if err:
        bad = (o_k != o_p).any(1).nonzero()[:5].flatten().tolist()
        raise AssertionError(f"SW kernel != plain (max abs err {err}, "
                             f"jobs {bad})")
    if not reps:
        return o_k, err, None, None
    ms = cuda_ms(lambda: sw_forward_batch(*args), reps)
    plain_ms = cuda_ms(lambda: sw_forward_plain(*args), 1)
    return o_k, err, ms, plain_ms


# ----------------------------------------------------------- phases 3-4


def _align(argv: list[str], logf) -> dict:
    from fastquick_tpu_torch.align import driver
    from fastquick_tpu_torch.cli import main

    t0 = time.perf_counter()
    with contextlib.redirect_stderr(logf):
        rc = main(["align"] + argv)
    if rc != 0:
        raise RuntimeError(f"align {' '.join(argv)} exited {rc}")
    st = dict(driver.LAST_RUN_STATS)
    st["wall_s"] = time.perf_counter() - t0
    return st


def _device_run(argv: list[str], logf, kernel: str,
                calls: dict | None = None) -> tuple[dict, dict]:
    """One ``align --device_qc`` run with the launch counts zeroed just
    before it; returns its stats and its launch counts (it raises unless
    its search kernel and the dense accumulation walk launched).  If
    calls is a dict, the inputs of each SW and width kernel launch are
    appended to its lists "sw" and "width", the first DeviceDenseStats
    chunk's inputs and its resident sums before and after it to "dense",
    and its flushes are counted into calls["flush"] (tools/
    dense_flush_probe.timed_flush)."""
    from fastquick_tpu_torch.align import device_qc
    from fastquick_tpu_torch.kernels import build
    from fastquick_tpu_torch.ops import batch_search, sw_kernels
    from tools.dense_flush_probe import timed_flush

    launch_sw = sw_kernels.sw_forward_batch
    launch_width = batch_search.width
    launch_dense = device_qc.dense_accumulate

    def record_dense(*args, out):
        first = not calls["dense"]
        before = out.clone() if first else None
        launch_dense(*args, out=out)
        if first:
            calls["dense"].append(([a.clone() if hasattr(a, "clone") else a
                                    for a in args], before, out.clone()))
        return out

    def record_sw(*args):
        calls["sw"].append([t.clone() for t in args])
        return launch_sw(*args)

    def record_width(fm, units, sel):
        calls["width"].append((fm, units.clone(), sel.clone()))
        return launch_width(fm, units, sel)

    build.reset_launch_counts()
    rec = calls is not None
    with mock.patch.dict(os.environ,
                         {"FQ_BS_PALLAS": "2"} if kernel == "scan" else {}), \
            mock.patch.object(sw_kernels, "sw_forward_batch",
                              record_sw if rec else launch_sw), \
            mock.patch.object(batch_search, "width",
                              record_width if rec else launch_width), \
            mock.patch.object(device_qc, "dense_accumulate",
                              record_dense if rec else launch_dense), \
            (timed_flush(device_qc, calls.setdefault("flush", {})) if rec
             else contextlib.nullcontext()):
        st = _align(argv + ["--device_qc"], logf)
    launches = dict(build.launch_counts)
    # the resident kernel counts its launches as "search"
    ran, idle = ("scan", "search") if kernel == "scan" else ("search", "scan")
    if st["search_kernel"] != kernel or not launches[ran] or launches[idle] \
            or not launches["accumulate"]:
        raise AssertionError(f"{kernel} run used the {st['search_kernel']} "
                             f"kernel, launches {launches}")
    return st, launches


def _check_dense_chunk(recorded: list, n_launches: int,
                       flushes: dict) -> dict:
    """The production align's first DeviceDenseStats chunk (its recorded
    inputs and resident sums before and after it) against the plain
    version, the walk timed again on it adding into resident sums; and
    its flushes: S, the host-clock time inside them, the copies to the
    host and their bytes (one drain: the sums' 4 (3 S + 1,025) bytes)."""
    import torch

    from fastquick_tpu_torch.ops import accumulate as acc

    if not recorded:
        raise AssertionError("production align: no DeviceDenseStats chunk")
    args, before, got = recorded[0]
    S = args[0].n_sites
    want = before + acc.pack_dense_plain(acc.dense_accumulate_plain(*args), S)
    if not torch.equal(got, want):
        bad = (got != want).nonzero()[:5].flatten().tolist()
        raise AssertionError(f"production DeviceDenseStats chunk != plain "
                             f"at {bad}")
    if flushes["copies"] != 1 or \
            flushes["bytes_to_host"] != 4 * acc.dense_size(S):
        raise AssertionError(f"production align: the dense sums went to the "
                             f"host {flushes['copies']} times "
                             f"({flushes['bytes_to_host']} bytes), not once")
    B, L = args[4].shape
    sums = torch.zeros_like(got)
    out = dict(reads=B, L=L, launches=n_launches, flushes=flushes,
               ms=cuda_ms(lambda: acc.dense_accumulate(*args, out=sums), 3))
    log(f"production align: {n_launches} dense accumulation walks; its "
        f"first DeviceDenseStats chunk ({B} reads x {L}) equal to plain, "
        f"dense_accumulate into the resident sums {out['ms']:.4f} ms; S "
        f"{flushes['S']} dense sites, {flushes['flushes']} flushes, "
        f"{flushes['flush_s']:.4f}s inside them (host clock), "
        f"{flushes['copies']} copy to the host of "
        f"{flushes['bytes_to_host']} bytes")
    return out


def phase_small(work: Path, logf) -> dict:
    from fastquick_tpu_torch.bench_configs import same_products
    from fastquick_tpu_torch.testing.synthworld import build_synth_pe_world

    d = work / "small"
    d.mkdir()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(logf):
        w = build_synth_pe_world(d)
    log(f"small world: {w['n_reads']} reads, index in "
        f"{time.perf_counter() - t0:.1f}s")
    common = ["--fastq_1", w["fq1"], "--fastq_2", w["fq2"],
              "--index_prefix", w["idx_prefix"]]
    dev, launches = _device_run(common + ["--out_prefix", str(d / "dev")],
                                logf, "resident")
    # the native engine, not the ~100 s host engine: the CPU tests hold
    # the device path to the reference's align on this world
    # (tests/test_torch_align_e2e.py)
    nat = _align(common + ["--out_prefix", str(d / "nat"),
                           "--engine", "native"], logf)
    same_products(str(d / "nat"), str(d / "dev"))
    log(f"small world: device {dev['wall_s']:.1f}s vs native "
        f"{nat['wall_s']:.1f}s, 12 product files byte-identical; "
        f"launches {launches}; fallback {dev['fallback']}/"
        f"{dev['searched']} {dev['fb_causes']}")
    scan, scan_launches = _device_run(
        common + ["--out_prefix", str(d / "scan")], logf, "scan")
    same_products(str(d / "nat"), str(d / "scan"))
    log(f"small world, scan kernel: device {scan['wall_s']:.1f}s, 12 "
        f"product files byte-identical to native; {scan['rounds']} rounds, "
        f"launches {scan_launches}; fallback {scan['fallback']}/"
        f"{scan['searched']} {scan['fb_causes']}")
    return dict(reads=w["n_reads"], device=dev, native=nat,
                launches=launches, scan=dict(device=scan,
                                             launches=scan_launches),
                world=w)


def phase_production(work: Path, logf, seed: int, pairs: int,
                     **world_kw) -> dict:
    from fastquick_tpu_torch.bench_configs import same_products
    from fastquick_tpu_torch.testing.synthworld import build_production_world

    d = work / "prod"
    d.mkdir()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(logf):
        w = build_production_world(d, seed=seed, n_pairs=pairs,
                                   **world_kw)
    t_world = time.perf_counter() - t0
    cut = " (cut from 100,000)" if pairs < 100_000 else ""
    log(f"production world: {w['genome_len'] / 1e6:.1f} Mbp genome, "
        f"10,000 markers, {pairs} read pairs{cut}; world + index built in "
        f"{t_world:.1f}s")
    common = ["--fastq_1", w["fq1"], "--fastq_2", w["fq2"],
              "--index_prefix", w["idx_prefix"]]
    calls: dict = {"sw": [], "width": [], "dense": []}
    dev, launches = _device_run(common + ["--out_prefix", str(d / "dev")],
                                logf, "resident", calls)
    nat = _align(common + ["--out_prefix", str(d / "nat"),
                           "--engine", "native"], logf)
    same_products(str(d / "nat"), str(d / "dev"))
    share = dev["fallback"] / max(dev["searched"], 1)
    rps = w["n_reads"] / dev["wall_s"]
    log(f"production: device_qc {dev['wall_s']:.1f}s ({rps:.0f} reads/s), "
        f"native {nat['wall_s']:.1f}s ({w['n_reads'] / nat['wall_s']:.0f} "
        f"reads/s); 12 product files byte-identical")
    log("production device phases: " + ", ".join(
        f"{k} {v:.2f}s" for k, v in sorted(dev["stage_t"].items(),
                                           key=lambda kv: -kv[1])))
    log("production native phases: " + ", ".join(
        f"{k} {v:.2f}s" for k, v in sorted(nat["stage_t"].items(),
                                           key=lambda kv: -kv[1])))
    log(f"production fallback: {dev['fallback']}/{dev['searched']} searched "
        f"reads ({100 * share:.2f}%), causes {dev['fb_causes']}; launches "
        f"{launches}")
    if share > 0.25:
        raise AssertionError(f"fallback share {share:.3f} above 0.25")
    width_shapes = []
    for fm, units, sel in calls["width"]:  # reads, then seeds, per chunk
        M, L = units.shape
        _, ms, plain_ms = width_case(fm, units, sel)
        width_shapes.append(dict(M=M, L=L, ms=ms, plain_ms=plain_ms))
        log(f"production width launch: {M} units x {L} codes; kernel "
            f"{ms:.3f} ms, plain {plain_ms:.1f} ms, equal")
    sw_shapes = []
    for i, args in enumerate(calls["sw"]):  # forward, reverse per rescue
        (B, RL), QL = args[0].shape, args[1].shape[1]
        cells = int((args[2].long() * args[3].long()).sum())
        _, _, ms, plain_ms = sw_case(args)
        sw_shapes.append(dict(launch="reverse" if i % 2 else "forward",
                              jobs=B, RL=RL, QL=QL, cells=cells, ms=ms,
                              plain_ms=plain_ms))
        share = cells / max(B * RL * QL, 1)
        log(f"production SW {sw_shapes[-1]['launch']} launch: {B} jobs, RL "
            f"{RL}, QL {QL}, {cells} true cells ({share:.1%} of the "
            f"padded); kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, equal")
    dense_chunk = _check_dense_chunk(calls["dense"], launches["accumulate"],
                                     calls["flush"])
    del calls

    scan, scan_launches = _device_run(
        common + ["--out_prefix", str(d / "scan")], logf, "scan")
    same_products(str(d / "nat"), str(d / "scan"))
    scan_share = scan["fallback"] / max(scan["searched"], 1)
    scan_rps = w["n_reads"] / scan["wall_s"]
    log(f"production, scan kernel: device_qc {scan['wall_s']:.1f}s "
        f"({scan_rps:.0f} reads/s); 12 product files byte-identical to "
        f"native; {scan['rounds']} rounds, {scan['busy']} busy steps, search "
        f"phase {scan['stage_t'].get('search', 0.0):.3f}s (default run "
        f"{dev['stage_t'].get('search', 0.0):.3f}s); launches "
        f"{scan_launches}")
    log("production scan-kernel phases: " + ", ".join(
        f"{k} {v:.2f}s" for k, v in sorted(scan["stage_t"].items(),
                                           key=lambda kv: -kv[1])))
    log(f"production scan-kernel fallback (not gated): {scan['fallback']}/"
        f"{scan['searched']} searched reads ({100 * scan_share:.2f}%), "
        f"causes {scan['fb_causes']}")
    return dict(reads=w["n_reads"], pairs=pairs, device=dev, native=nat,
                reads_per_s=rps, native_reads_per_s=w["n_reads"]
                / nat["wall_s"], fallback_share=share, launches=launches,
                world_s=t_world, sw_launches=sw_shapes,
                width_launches=width_shapes, dense_chunk=dense_chunk,
                scan=dict(device=scan, launches=scan_launches,
                          reads_per_s=scan_rps, fallback_share=scan_share),
                world=w)


# ------------------------------------------------------------- phase 5


PROGRAM_COUNTERS = ("n_mapped", "n_eligible", "n_pair_reads", "n_pcr_dup",
                    "pileup_ovf", "n_pair_ovf")


def _stage_line(times: dict) -> str:
    return ", ".join(f"{k} {v:.3f}s" for k, v in times.items())


def _segments() -> dict:
    """The caching allocator's device allocations (cudaMalloc calls) and
    its retries after freeing its cache, so far in this process."""
    import torch

    st = torch.cuda.memory_stats()
    return dict(segments=st.get("segment.all.allocated", 0),
                retries=st.get("num_alloc_retries", 0))


def _seg_delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a}


@contextlib.contextmanager
def _recording(calls: dict):
    """Record what qc_step_full hands its drand48, resident-search and
    pairing wrappers and what they return: every draw in calls["draw"],
    the first search (its inputs cloned before the kernel edits widths in
    place) in calls["search"], every pairing sweep in calls["pairing"].
    The pairing stage's parts are timed by CUDA events around each call,
    into calls["events"] as (part, k_occ, start, end): the isize
    inference (its histogram and the estimate), each expansion and each
    sweep."""
    import torch

    from fastquick_tpu_torch.ops import qc_full

    draw, search = qc_full.aln2seq_draw_scan, qc_full.resident_search
    sweep = qc_full.pairing_sweep
    events = calls.setdefault("events", [])

    def timed(part, fn, k_of):
        def run(*args, **kw):
            e = (torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True))
            e[0].record()
            out = fn(*args, **kw)
            e[1].record()
            events.append((part, k_of(args), *e))
            return out
        return run

    def record_draw(n_aln, alns, state0):
        args = (n_aln.clone(), alns.clone(),
                torch.as_tensor(state0, dtype=torch.int32,
                                device=alns.device).clone())
        out = draw(n_aln, alns, state0)
        calls["draw"].append((args, out))
        return out

    def record_search(fm, P, **inp):
        first = not calls["search"]
        args = {k: v.clone() for k, v in inp.items()} if first else None
        out = search(fm, P, **inp)
        if first:
            calls["search"].append((fm, P, args, out))
        return out

    timed_sweep = timed("sweep", sweep, lambda a: a[0]["pos"].shape[1])

    def record_sweep(*args):
        out = timed_sweep(*args)
        calls["pairing"].append((args, out))
        return out

    def none(_):
        return None

    with mock.patch.object(qc_full, "aln2seq_draw_scan", record_draw), \
            mock.patch.object(qc_full, "resident_search", record_search), \
            mock.patch.object(qc_full, "pairing_sweep", record_sweep), \
            mock.patch.object(qc_full, "isize_hist_local", timed(
                "isize", qc_full.isize_hist_local, none)), \
            mock.patch.object(qc_full, "infer_isize_from_hist", timed(
                "isize", qc_full.infer_isize_from_hist, none)), \
            mock.patch.object(qc_full, "expand_occurrences", timed(
                "expansion", qc_full.expand_occurrences, lambda a: a[5])):
        yield


def _pairing_split(events: list, k_occ: int) -> dict:
    """The fill pass's pairing stage by its parts' CUDA events (ms): the
    isize inference, the expansions and the sweep at k_occ.  A pass's
    events start at its first isize part; the fill pass is the last."""
    import torch

    torch.cuda.synchronize()
    passes: list = []
    for ev in events:
        if ev[0] == "isize" and (not passes or passes[-1][-1][0] != "isize"):
            passes.append([])
        passes[-1].append(ev)
    out = {"isize": 0.0, "expansion": 0.0, "sweep": 0.0}
    for part, k, a, b in passes[-1] if passes else []:
        if k in (None, k_occ):
            out[part] += a.elapsed_time(b)
    return out


def _check_sweeps(sweeps: list, name: str) -> list:
    """Each recorded pairing sweep of a production run against the plain
    version on the same inputs: every output field and cnt_chg equal."""
    import torch

    from fastquick_tpu_torch.ops.pe_device import (
        pairing_sweep,
        pairing_sweep_plain,
    )
    from fastquick_tpu_torch.testing.pairing_cases import same_sweep

    out = []
    for i, (args, got) in enumerate(sweeps):
        t0 = time.perf_counter()
        want = pairing_sweep_plain(*args)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        same_sweep(got, want, f"production {name}, pairing sweep {i} != "
                   "plain")
        P, K = args[0]["pos"].shape
        out.append(dict(pairs=P, k_occ=K, cnt_chg=int(got[2]),
                        plain_s=plain_s,
                        ms=cuda_ms(lambda: pairing_sweep(*args), 3)))
    log(f"program production, {name}: its {len(sweeps)} pairing sweeps "
        f"equal to plain in every output and cnt_chg ("
        + ", ".join(f"{c['pairs']} pairs at K {c['k_occ']}, cnt_chg "
                    f"{c['cnt_chg']}, pairing_sweep {c['ms']:.4f} ms, "
                    f"plain {c['plain_s']:.2f}s" for c in out) + ")")
    return out


def _check_draws(draws: list, name: str) -> list:
    """Each recorded drand48 launch of a production run against the plain
    version on the same inputs: words, rows and final state equal; the
    kernel timed again on them by CUDA events."""
    from fastquick_tpu_torch.ops.drand48_device import (
        aln2seq_draw_scan,
        best_class,
        draw_scan_plain,
    )

    out = []
    for i, (args, got) in enumerate(draws):
        walk: dict = {}
        t0 = time.perf_counter()
        want = draw_scan_plain(*args, stats=walk)
        plain_s = time.perf_counter() - t0
        same_draw(got, want, f"production {name}, drand48 launch {i} != "
                  "plain")
        nb = best_class(args[0], args[1])
        out.append(dict(reads=int(args[0].shape[0]), draws=walk["draws"],
                        single=int((nb == 1).sum()),
                        multi=int((nb > 1).sum()), plain_s=plain_s,
                        ms=cuda_ms(lambda: aln2seq_draw_scan(*args), 3)))
    log(f"program production, {name}: its {len(draws)} drand48 launches "
        f"equal to plain in words, rows and state ("
        + ", ".join(f"{c['reads']} reads ({c['single']} single-row, "
                    f"{c['multi']} multi-row), {c['draws']} draws, kernel "
                    f"{c['ms']:.3f} ms, plain {c['plain_s']:.2f}s"
                    for c in out) + ")")
    return out


def _check_accumulates(calls: list, launches: dict, name: str) -> list:
    """Each recorded accumulation of a production run (the first pass's
    and the fill pass's accumulate_pileup) against the plain versions on
    its own inputs, every output equal; the wrapper timed again on them.
    Raises unless each made one walk of the grid and one order launch:
    the walk and order launches counted both equal the calls recorded."""
    from fastquick_tpu_torch.ops import accumulate as acc
    from fastquick_tpu_torch.testing.accumulate_cases import check_launches

    n = len(calls)
    if not n or launches["accumulate"] != n or launches["pileup"] != n:
        raise AssertionError(f"production {name}: {n} accumulations "
                             f"recorded, launched {launches}")
    t0 = time.perf_counter()
    held = check_launches(calls, f"production {name}")
    plain_s = time.perf_counter() - t0
    out = [dict(reads=B, L=L, marker_base=mb,
                ms=cuda_ms(lambda: acc.accumulate_pileup(*args), 3))
           for (B, L, mb), (args, _) in zip(held, calls)]
    log(f"program production, {name}: its {n} accumulations, one walk of "
        f"the (B, L) grid and one order launch each ({launches['accumulate']}"
        f" walk and {launches['pileup']} order launches), equal to plain in "
        "every output (" + ", ".join(
            f"{c['reads']} x {c['L']}, marker_base {c['marker_base']}, "
            f"{c['ms']:.4f} ms" for c in out)
        + f"; plain {plain_s:.2f}s all)")
    return out


def _check_search(call, name: str) -> dict:
    """The first pass's search launch of a production run against the
    plain version on an evenly spaced sample of its reads: hits, fallback
    bits and steps equal (a read's search depends on its own inputs
    only)."""
    import torch

    from fastquick_tpu_torch.ops.search_kernels import FB_POOL, search_plain

    fm, P, inp, got = call
    N = inp["seqs0"].shape[0]
    n = min(N, PROGRAM_SEARCH_CHECK)
    idx = torch.arange(n, device=inp["seqs0"].device) * (N // n)
    both = torch.cat([idx, idx + N])  # width rows: strand 0, then 1
    sub = {k: v[both] if k in ("widths", "seed_w") else v[idx]
           for k, v in inp.items()}
    t0 = time.perf_counter()
    want = search_plain(fm, P, **sub)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    same_search([t[idx] for t in got], want,
                f"production {name}, chain {P.CH} search launch != plain")
    fb = got[2][idx]
    out = dict(reads=n, of=N, pool=P.NP, chain=P.CH, step_cap=P.step_cap,
               fallback=int((fb != 0).sum()),
               pool_fallback=int(((fb & FB_POOL) != 0).sum()),
               max_steps=int(got[3][idx].max()), plain_s=plain_s)
    log(f"program production, {name}: first-pass search launch (pool "
        f"{P.NP}, chain {P.CH}, cap {P.step_cap}) equal to plain on {n} of "
        f"its {N} reads in hits, fallback bits and steps; {out['fallback']}"
        f" fallback ({out['pool_fallback']} pool overflows), longest read "
        f"{out['max_steps']} steps; plain {plain_s:.1f}s")
    return out


@contextlib.contextmanager
def _recording_fill(calls: dict):
    """Record run_with_fill's fill (ops/host_redo.fill): its fallback bits,
    block and output (on the host) and counters in calls["fill"], and each
    launch of the card's retry by CUDA events around it in
    calls["retry_events"]."""
    import torch

    from fastquick_tpu_torch.ops import host_redo

    fill, search = host_redo.fill, host_redo.resident_search
    events = calls.setdefault("retry_events", [])

    def record_fill(world, engine, fb, lo, B, dev):
        out, counts = fill(world, engine, fb, lo, B, dev)
        calls.setdefault("fill", []).append(
            ((fb.copy(), lo, B), tuple(t.cpu() for t in out), counts))
        return out, counts

    def timed_search(fm, P, **kw):
        e = (torch.cuda.Event(enable_timing=True),
             torch.cuda.Event(enable_timing=True))
        e[0].record()
        out = search(fm, P, **kw)
        e[1].record()
        events.append((P.NP, kw["seqs0"].shape[0], *e))
        return out

    with mock.patch.object(host_redo, "fill", record_fill), \
            mock.patch.object(host_redo, "resident_search", timed_search):
        yield


def _check_fill(world, calls: dict, name: str) -> dict:
    """The fill of a production run_with_fill call against the route
    through Read objects on the same fallback rows: the native engine's
    align_batch on all of them and the Python oracle's (HostEngine) on
    PROGRAM_FILL_ORACLE of them, evenly spaced, each packed by
    pack_host_hits; bit-identical.  With the card retry's counters and its
    launches' times."""
    import copy

    import numpy as np
    import torch

    from fastquick_tpu_torch.align.engine import HostEngine, NativeEngine
    from fastquick_tpu_torch.ops.qc_full import pack_host_hits

    ((fb, lo, B), (got_n, got_rows), counts), = calls["fill"]
    got_n, got_rows = got_n.numpy(), got_rows.numpy()
    rows_idx = np.nonzero(fb)[0]
    rows_idx = rows_idx[lo + rows_idx < B]
    t0 = time.perf_counter()
    reads = [copy.copy(world["reads"][lo + b]) for b in rows_idx]
    NativeEngine(world["idx"]).align_batch(reads, world["opt"])
    want_n, want_rows = pack_host_hits(reads, rows_idx, len(fb))
    native_s = time.perf_counter() - t0
    if not (np.array_equal(got_n, want_n)
            and np.array_equal(got_rows, want_rows)):
        bad = np.nonzero((got_n != want_n)
                         | (got_rows != want_rows).any((1, 2)))[0]
        raise AssertionError(f"production {name}: the fill differs from the "
                             f"native engine's object route on {len(bad)} "
                             f"of {len(rows_idx)} rows, e.g. {bad[:8]}")
    pick = rows_idx[np.unique(np.linspace(
        0, len(rows_idx) - 1, min(len(rows_idx), PROGRAM_FILL_ORACLE)
    ).astype(int))] if len(rows_idx) else rows_idx
    t0 = time.perf_counter()
    reads = [copy.copy(world["reads"][lo + b]) for b in pick]
    HostEngine(world["idx"]).align_batch(reads, world["opt"])
    o_n, o_rows = pack_host_hits(reads, np.arange(len(pick)), len(pick))
    oracle_s = time.perf_counter() - t0
    if not (np.array_equal(got_n[pick], o_n)
            and np.array_equal(got_rows[pick], o_rows)):
        raise AssertionError(f"production {name}: the fill differs from the "
                             f"Python oracle's on its {len(pick)} rows")
    torch.cuda.synchronize()
    launches = [(NP, n, a.elapsed_time(b))
                for NP, n, a, b in calls["retry_events"]]
    out = dict(counts, rows=len(rows_idx), oracle_rows=len(pick),
               native_s=native_s, oracle_s=oracle_s, retry_launches=launches)
    log(f"program production, {name}: the fill of {len(rows_idx)} fallback "
        f"rows bit-identical to the native engine's object route on all of "
        f"them ({native_s:.1f}s) and to the Python oracle's on "
        f"{len(pick)} ({oracle_s:.1f}s); card retry: "
        f"card_retry_rows {counts['card_retry_rows']}, card_retry_done "
        f"{counts['card_retry_done']}, redo_rows {counts['redo_rows']}; "
        f"launches (slots, rows, ms by events): "
        f"{[(NP, n, round(ms, 3)) for NP, n, ms in launches]}")
    return out


def _unrecorded_run(qp, world, engine, name: str, recorded) -> dict:
    """The production recipe once more with nothing recorded (the
    recording holds the first pass's planes and search inputs until its
    checks): its stage times and the allocator's new segments, and its
    accumulators and rows equal to the recorded run's."""
    import torch

    times: dict = {}
    seg0 = _segments()
    t0 = time.perf_counter()
    stats, rows, _ = qp.run_with_fill(world, engine=engine, kernel=name,
                                      times=times)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    alloc = _seg_delta(seg0, _segments())
    qp.same_run((stats, rows), recorded,
                f"production {name}, unrecorded vs recorded")
    step_s = sum(v for k, v in times.items()
                 if k not in ("first_pass", "host_redo"))
    log(f"program production, {name}, again with nothing recorded: whole "
        f"{wall:.2f}s, fill pass {step_s:.3f}s; stages {_stage_line(times)};"
        f" allocator {alloc}; equal to the recorded run")
    return dict(wall_s=wall, step_s=step_s, times=times, alloc=alloc)


def phase_program(work: Path, logf, seed: int, pairs: int,
                  small_w: dict | None = None,
                  prod_w: dict | None = None) -> dict:
    import torch

    from fastquick_tpu_torch import qc_program as qp
    from fastquick_tpu_torch.align.engine import NativeEngine
    from fastquick_tpu_torch.kernels import build
    from fastquick_tpu_torch.testing.accumulate_cases import (
        recorded_launches,
    )
    from fastquick_tpu_torch.testing.synthworld import (
        build_production_world,
        build_synth_pe_world,
    )

    d = work / "program"
    d.mkdir()
    res: dict = {}
    with contextlib.redirect_stderr(logf):
        if small_w is None:
            (work / "small").mkdir(exist_ok=True)
            small_w = build_synth_pe_world(work / "small")
        if prod_w is None:
            (work / "prod").mkdir(exist_ok=True)
            prod_w = build_production_world(work / "prod", seed=seed,
                                            n_pairs=pairs)

    # ---- the small world: the card against the plain versions ----
    def small_world(device):
        with contextlib.redirect_stderr(logf):
            return qp.world_from_files(
                small_w["tmp"], small_w["idx_prefix"], small_w["fq1"],
                small_w["fq2"], "r_1.fq", "r_2.fq", device=device)

    out = {}
    for device in ("cuda", "cpu"):
        w = small_world(device)
        build.reset_launch_counts()
        times: dict = {}
        t0 = time.perf_counter()
        stats, rows = qp.run_single(w, times=times)
        wall = time.perf_counter() - t0
        with contextlib.redirect_stderr(logf):
            files = qp.write_product(str(d / f"small_{device}"), stats, rows,
                                     w["names"], w)
        out[device] = dict(run=(stats, rows), files=files, wall_s=wall,
                           times=times, launches=dict(build.launch_counts))
        log(f"program small world on {device}: {2 * w['n_pairs']} reads, "
            f"{wall:.2f}s ({_stage_line(times)}); n_mapped "
            f"{int(stats['n_mapped'])}, n_fallback "
            f"{int(stats['n_fallback'])}; launches "
            f"{out[device]['launches']}")
    qp.same_run(out["cuda"]["run"], out["cpu"]["run"],
                "small world, cuda vs cpu")
    n_files = qp.same_files(out["cuda"]["files"], out["cpu"]["files"],
                            "small world, cuda vs cpu")
    log(f"program small world: cuda run equal to the cpu run in every "
        f"accumulator and row; {n_files} product files byte-identical")
    res["small"] = {dev: dict(wall_s=o["wall_s"], times=o["times"],
                              launches=o["launches"])
                    for dev, o in out.items()}

    # ---- production: one batch of every pair, resident and scan ----
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(logf):
        world = qp.world_from_files(
            prod_w["tmp"], prod_w["idx_prefix"], prod_w["fq1"],
            prod_w["fq2"], "r_1.fq", "r_2.fq", device="cuda", L=160,
            bitmaps=True)
    n_reads = 2 * world["n_pairs"]
    log(f"program production world: {n_reads} reads as one batch (L 160, "
        f"k-mer bitmaps on the card) loaded in "
        f"{time.perf_counter() - t0:.1f}s")
    # the exact redo: the native engine itself (raises if its library is
    # missing), so the host redo's time is the native engine's
    engine = NativeEngine(world["idx"])
    res["redo_engine"] = type(engine).__name__
    runs = {}
    for name, opts in (("resident", dict(pool=QC_POOL, chain=QC_CHAIN,
                                         step_cap=QC_CAP_PER_BASE * 160)),
                       ("scan", dict(pool=512, chain=1, step_cap=768))):
        world["opt_args"].update(opts)
        calls: dict = {"draw": [], "search": [], "pairing": [], "acc": []}
        build.reset_launch_counts()
        times = {}
        seg0 = _segments()
        t0 = time.perf_counter()
        with _recording(calls), recorded_launches(calls["acc"]), \
                _recording_fill(calls):
            stats, rows, fb1 = qp.run_with_fill(world, engine=engine,
                                                kernel=name, times=times)
        retry_s = qp.LAST_RUN_STATS["stage_t"].get("program.host_redo.card")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        alloc = _seg_delta(seg0, _segments())
        launches = dict(build.launch_counts)
        if int(stats["n_fallback"]):
            raise AssertionError(f"production {name}: "
                                 f"{int(stats['n_fallback'])} fallback reads "
                                 "left after the fill pass")
        with contextlib.redirect_stderr(logf):
            files = qp.write_product(str(d / f"prod_{name}"), stats, rows,
                                     world["names"], world)
        step_s = sum(v for k, v in times.items()
                     if k not in ("first_pass", "host_redo"))
        counters = {k: int(stats[k]) for k in PROGRAM_COUNTERS}
        runs[name] = dict(run=(stats, rows), files=files)
        # the mesh phase holds its mesh-2 runs to this one
        saved = d / f"prod_{name}.pkl"
        with open(saved, "wb") as fh:
            pickle.dump(dict(stats={k: v.cpu().numpy()
                                    for k, v in stats.items()},
                             rows=rows, files=files), fh)
        res[name] = dict(opts=opts, fallback_first=fb1, wall_s=wall,
                         saved=str(saved), alloc=alloc,
                         step_s=step_s, times=times, launches=launches,
                         reads_per_s=n_reads / wall,
                         step_reads_per_s=n_reads / step_s, **counters)
        log(f"program production, {name} kernel {opts}: first pass "
            f"{fb1} fallback reads, none after the fill; whole "
            f"{wall:.2f}s ({n_reads / wall:.0f} reads/s), fill pass "
            f"{step_s:.3f}s ({n_reads / step_s:.0f} reads/s); stages "
            f"{_stage_line(times)} (host redo by {res['redo_engine']}); "
            f"{counters}; launches {launches}; allocator {alloc}")
        if launches["pairing"] != len(calls["pairing"]) or \
                not launches["pairing"]:
            raise AssertionError(f"production {name}: {len(calls['pairing'])}"
                                 f" pairing sweeps, {launches['pairing']} "
                                 "pairing kernel launches")
        log(f"program production, {name}: pairing "
            f"{times.get('pairing', 0):.3f}s, second_pass "
            f"{times.get('second_pass', 0):.3f}s, drand48 "
            f"{times.get('drand48', 0):.3f}s; {launches['pairing']} pairing "
            f"launches, one a sweep")
        k_occ = int(world["opt_args"].get("k_occ", 32))
        split = _pairing_split(calls["events"], k_occ)
        res[name]["pairing_split_ms"] = split
        log(f"program production, {name}: the fill pass's pairing stage "
            f"{1e3 * times.get('pairing', 0):.3f} ms (host clock) by its "
            f"parts' CUDA events: isize inference {split['isize']:.4f} ms, "
            f"the two expansions at k_occ {k_occ} "
            f"{split['expansion']:.4f} ms, the sweep {split['sweep']:.4f} "
            f"ms")
        res[name]["fill_check"] = _check_fill(world, calls, name)
        res[name]["fill_check"]["retry_span_s"] = retry_s
        log(f"program production, {name}: span program.host_redo.card "
            f"{retry_s:.4f}s (the retry's widths, launches and waits, host "
            f"clock), program.host_redo {times['host_redo']:.4f}s")
        res[name]["draw_checks"] = _check_draws(calls["draw"], name)
        res[name]["sweep_checks"] = _check_sweeps(calls["pairing"], name)
        res[name]["accumulate_checks"] = _check_accumulates(
            calls.pop("acc"), launches, name)
        if calls["search"]:
            res[name]["search_check"] = _check_search(calls["search"][0],
                                                      name)
        del calls
        res[name]["unrecorded"] = _unrecorded_run(qp, world, engine, name,
                                                  runs[name]["run"])
    qp.same_run(runs["resident"]["run"], runs["scan"]["run"],
                "production, resident vs scan")
    n_files = qp.same_files(runs["resident"]["files"],
                            runs["scan"]["files"],
                            "production, resident vs scan")
    log(f"program production: resident and scan runs equal in every "
        f"accumulator, n_pcr_dup and row; {n_files} product files "
        f"byte-identical")
    return res


# ------------------------------------------------------------- phase 6


# the files tests/test_shard_merge.py:65-84 holds a merge to a single run
# by (with the Pileup's per-marker depths and sorted bases); the first four
# hold on any world, the last three only where no read's hits are drawn
MERGE_FILES = ("DepthDist", "GCDist", "EmpRepDist", "EmpCycleDist",
               "RawInsertSizeDist", "AdjustedInsertSizeDist", "Summary")
# the (pc, alpha) points of tests/test_device_llk.py:23-24
LLK_POINTS = (([0.0, 0.0], 0.03), ([0.05, -0.02], 0.2), ([-0.1, 0.1], 0.45))
LLK_REPS = 200


def _split_fastq(src: str, out_a: str, out_b: str) -> int:
    """Split a gzip FASTQ into its first and second half by record."""
    import gzip

    with gzip.open(src, "rt") as fh:
        lines = fh.readlines()
    half = len(lines) // 8 * 4
    with gzip.open(out_a, "wt", compresslevel=1) as fa:
        fa.writelines(lines[:half])
    with gzip.open(out_b, "wt", compresslevel=1) as fb:
        fb.writelines(lines[half:])
    return len(lines) // 4


def _pileup_depths(path: str) -> dict:
    """Per-marker depth and sorted bases of a .Pileup."""
    out = {}
    with open(path) as fh:
        for line in fh:
            c = line.split("\t")
            out[int(c[1])] = (int(c[3]), "".join(sorted(c[4].upper())))
    return out


def _freemix(prefix: str) -> float:
    with open(prefix + ".selfSM") as fh:
        return float(fh.read().splitlines()[1].split("\t")[6])


def _ancestry(prefix: str) -> str:
    with open(prefix + ".Ancestry") as fh:
        return "; ".join(line.strip().replace("\t", " ")
                         for line in fh.readlines()[1:])


def _cli(argv: list[str], logf) -> float:
    """One fastquick-torch command, its output to the log; its wall s."""
    from fastquick_tpu_torch.cli import main

    t0 = time.perf_counter()
    with contextlib.redirect_stderr(logf), contextlib.redirect_stdout(logf):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"{' '.join(argv[:1])} exited {rc}")
    return time.perf_counter() - t0


@contextlib.contextmanager
def _stage_clock(times: dict, after_align):
    """Time the pipeline's stages as fastquick_tpu_torch/pipeline.py calls
    them (the SVD build, align, pop+con, report); after_align() runs as
    soon as align returns, before pop+con appends to its .Summary."""
    from fastquick_tpu_torch.align import driver as align_driver
    from fastquick_tpu_torch.pop import driver as pop_driver
    from fastquick_tpu_torch.report import report

    run_align, run_popcon = align_driver.run_align, pop_driver.run_popcon
    gen_report = report.generate_report

    def clocked(name, fn, after=None):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            times[name] = time.perf_counter() - t0
            if after:
                after()
            return out
        return run

    def popcon(argv):
        name = "svd" if "--RefVCF" in argv else "pop+con"
        return clocked(name, run_popcon)(argv)

    with mock.patch.object(align_driver, "run_align",
                           clocked("align", run_align, after_align)), \
            mock.patch.object(pop_driver, "run_popcon", popcon), \
            mock.patch.object(report, "generate_report",
                              clocked("report", gen_report)):
        yield


def phase_pipeline(work: Path, logf, seed: int, pairs: int,
                   small_w: dict | None = None,
                   prod_w: dict | None = None) -> dict:
    import importlib.util

    import torch

    from fastquick_tpu_torch.bench_configs import PRODUCTS, same_products
    from fastquick_tpu_torch.kernels import build
    from fastquick_tpu_torch.pop import device_llk
    from fastquick_tpu_torch.pop import estimator as pop_est
    from fastquick_tpu_torch.pop.pileup import read_pileup_file
    from fastquick_tpu_torch.testing.popcon_cases import estimator_from_files
    from fastquick_tpu_torch.testing.synthworld import (
        build_production_world,
        build_synth_pe_world,
        write_panel,
    )

    d = work / "pipeline"
    d.mkdir()
    res: dict = {}
    with contextlib.redirect_stderr(logf):
        if small_w is None:
            (work / "small").mkdir(exist_ok=True)
            small_w = build_synth_pe_world(work / "small")
        if prod_w is None:
            (work / "prod").mkdir(exist_ok=True)
            prod_w = build_production_world(work / "prod", seed=seed,
                                            n_pairs=pairs)
    # phase 3's single device run and phase 4's native run, else made here
    small_dev = str(Path(small_w["tmp"]) / "dev")
    if not Path(small_dev + ".Summary").exists():
        _device_run(["--fastq_1", small_w["fq1"], "--fastq_2",
                     small_w["fq2"], "--index_prefix", small_w["idx_prefix"],
                     "--out_prefix", small_dev], logf, "resident")
    nat = str(Path(prod_w["tmp"]) / "nat")
    if not Path(nat + ".Summary").exists():
        _align(["--fastq_1", prod_w["fq1"], "--fastq_2", prod_w["fq2"],
                "--index_prefix", prod_w["idx_prefix"], "--out_prefix", nat,
                "--engine", "native"], logf)

    # ---- the small world: two shards on the card, then merge ----
    halves = {}
    for h in "ab":
        halves[h] = (str(d / f"{h}_1.fq.gz"), str(d / f"{h}_2.fq.gz"))
    n1 = _split_fastq(small_w["fq1"], halves["a"][0], halves["b"][0])
    _split_fastq(small_w["fq2"], halves["a"][1], halves["b"][1])
    shards, merge_s = {}, {}
    for h, (f1, f2) in halves.items():
        args = ["--fastq_1", f1, "--fastq_2", f2, "--index_prefix",
                small_w["idx_prefix"], "--shard_out"]
        st, launches = _device_run(
            args + ["--out_prefix", str(d / f"dev_{h}")], logf, "resident")
        nat_st = _align(args + ["--out_prefix", str(d / f"nat_{h}"),
                                "--engine", "native"], logf)
        shards[h] = dict(wall_s=st["wall_s"], launches=launches,
                         native_wall_s=nat_st["wall_s"])
        if not filecmp.cmp(d / f"dev_{h}.bam", d / f"nat_{h}.bam",
                           shallow=False):
            raise AssertionError(f"shard {h}: device BAM differs from native")
    for eng in ("dev", "nat"):
        merge_s[eng] = _cli(["merge", "--index_prefix", small_w["idx_prefix"],
                             "--out_prefix", str(d / f"{eng}_merged"),
                             str(d / f"{eng}_a"), str(d / f"{eng}_b")], logf)
    merged = str(d / "dev_merged")
    # merge writes every product file but the BAM
    same_products(str(d / "nat_merged"), merged, PRODUCTS[:-1])
    # against the single run: the files whose sums do not depend on the
    # order of the reads (the drand48 stream of the repeat markers' hit
    # draws restarts in each shard, so their pairs may differ)
    same = {sfx: filecmp.cmp(f"{small_dev}.{sfx}", f"{merged}.{sfx}",
                             shallow=False) for sfx in MERGE_FILES}
    if not all(same[sfx] for sfx in MERGE_FILES[:4]):
        raise AssertionError(f"merged against the single device run: {same}")
    if _pileup_depths(small_dev + ".Pileup") != _pileup_depths(
            merged + ".Pileup"):
        raise AssertionError("merged .Pileup depths or bases differ from "
                             "the single device run")
    log(f"pipeline small world: {2 * n1} reads in two --shard_out device "
        f"runs ({shards['a']['wall_s']:.1f}s, {shards['b']['wall_s']:.1f}s; "
        f"launches {shards['a']['launches']}, {shards['b']['launches']}), "
        f"merge {merge_s['dev']:.2f}s: shard BAMs and the 11 merged product "
        "files byte-identical to native shards and their merge; against "
        "the single device run, Pileup depths and bases equal and "
        + ", ".join(f"{k} {'identical' if v else 'different'}"
                    for k, v in same.items()))
    res["shard_merge"] = dict(shards=shards, merge_s=merge_s,
                              same_as_single=same)

    # ---- production: the pipeline through its entry point ----
    panel = write_panel(prod_w, seed=seed)
    out = str(d / "sample")
    align_args = ["--index_prefix", prod_w["idx_prefix"], "--out_prefix",
                  out, "--device", "cuda", "--fastq_1", prod_w["fq1"],
                  "--fastq_2", prod_w["fq2"]]
    popcon_args = ["--DisableSanityCheck", "--PileupFile", out + ".Pileup",
                   "--SVDPrefix", panel, "--Output", out, "--device", "cuda"]

    def same_as_native():
        same_products(nat, out)

    times: dict = {}
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    build.reset_launch_counts()
    t0 = time.perf_counter()
    with _stage_clock(times, same_as_native):
        if has_mpl:
            _cli(["all", "--steps", "AllButIndex", "--device", "cuda",
                  "--index", prod_w["idx_prefix"], "--RefVCF", panel,
                  "--DisableSanityCheck", "--fastq_1", prod_w["fq1"],
                  "--fastq_2", prod_w["fq2"], "--output", out], logf)
        else:
            log("pipeline production: the report stage does not run, "
                "matplotlib is not installed on this machine; all's other "
                "stages run by their own commands, in all's order")
            _cli(["pop+con", "--RefVCF", panel], logf)
            _cli(["align"] + align_args, logf)
            _cli(["pop+con"] + popcon_args, logf)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    if not (launches["width"] and launches["search"] and launches["sw"]):
        raise AssertionError(f"the pipeline's align launched {launches}")
    if "align" not in times or not Path(out + ".selfSM").exists():
        raise AssertionError(f"the pipeline ran only {sorted(times)}")
    fm = _freemix(out)
    how = "fastquick-torch all" if has_mpl else "all's stages, no report"
    log(f"pipeline production ({how}): {wall:.1f}s; stages "
        + ", ".join(f"{k} {v:.2f}s" for k, v in times.items())
        + f"; the 12 align product files byte-identical to the native run; "
        f"launches {launches}; FREEMIX {fm}; Ancestry {_ancestry(out)}")
    res["production"] = dict(all=has_mpl, wall_s=wall, stages=times,
                             launches=launches, freemix=fm,
                             ancestry=_ancestry(out), panel=panel,
                             pileup=out + ".Pileup")

    # ---- production: the device likelihood on the card ----
    n_eval = [0]
    compute = pop_est.ContaminationEstimator.compute_mix_llks

    def counted(self, *args):
        n_eval[0] += 1
        return compute(self, *args)

    with mock.patch.object(pop_est.ContaminationEstimator,
                           "compute_mix_llks", counted), \
            mock.patch.object(device_llk, "DEVICE_DEFAULT", "cuda"):
        llk_s = _cli(["pop+con", "--DeviceLLK", "--DisableSanityCheck",
                      "--PileupFile", out + ".Pileup", "--SVDPrefix", panel,
                      "--Output", str(d / "llk"), "--device", "cuda"], logf)
        cli_evals = n_eval[0]
        fm_dev = _freemix(str(d / "llk"))
        if abs(fm_dev - fm) > 5e-3:
            raise AssertionError(f"--DeviceLLK FREEMIX {fm_dev} against "
                                 f"numpy's {fm}")
        solves = {}
        for name, use_device in (("numpy", False), ("device", True)):
            est = estimator_from_files(pop_est.ContaminationEstimator,
                                       read_pileup_file, panel,
                                       out + ".Pileup", num_pc=4)
            est.use_device = use_device
            n_eval[0] = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(logf):
                est.optimize(str(d / f"solve_{name}"))
            solves[name] = dict(wall_s=time.perf_counter() - t0,
                                evals=n_eval[0], alpha=est.global_alpha)

    est = estimator_from_files(pop_est.ContaminationEstimator,
                               read_pileup_file, panel, out + ".Pileup")
    est._prepare()
    llk = device_llk.DeviceLLK(est._counts, est._UD_act, est._means_act,
                               device="cuda")
    errs = []
    for pc, a in LLK_POINTS:
        got, want = llk(pc, pc, a), est.compute_mix_llks(pc, pc, a)
        errs.append(abs(got - want) / abs(want))
        if errs[-1] > 2e-5:
            raise AssertionError(f"DeviceLLK {got} against numpy {want} at "
                                 f"{pc}, {a}")
    pc, a = LLK_POINTS[1]
    for _ in range(10):
        llk(pc, pc, a)
    t0 = time.perf_counter()
    for _ in range(LLK_REPS):
        llk(pc, pc, a)
    call_ms = (time.perf_counter() - t0) / LLK_REPS * 1e3
    f32 = dict(dtype=torch.float32, device=llk.device)
    pc_t, a_t = torch.tensor(pc, **f32), torch.tensor(a, **f32)
    eval_ms = cuda_ms(lambda: llk.llk(pc_t, pc_t, a_t), LLK_REPS)
    # the same evaluation replayed as one CUDA graph: the device's own
    # work, without the host's dispatch of its ~25 small kernels
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        llk.llk(pc_t, pc_t, a_t)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = llk.llk(pc_t, pc_t, a_t)
    graph_ms = cuda_ms(graph.replay, LLK_REPS)
    if float(replayed) != float(llk.llk(pc_t, pc_t, a_t)):
        raise AssertionError("the graph replay of DeviceLLK differs")
    for _ in range(10):
        est.compute_mix_llks(pc, pc, a)
    t0 = time.perf_counter()
    for _ in range(LLK_REPS):
        est.compute_mix_llks(pc, pc, a)
    numpy_ms = (time.perf_counter() - t0) / LLK_REPS * 1e3
    log(f"pipeline DeviceLLK on {llk.device}: {est._counts.shape[0]} "
        f"markers x {est._counts.shape[1]} bins; rel err against numpy at "
        f"the 3 points {['%.2e' % e for e in errs]} (<= 2e-5); one "
        f"evaluation {eval_ms} ms on the device (CUDA events, mean of "
        f"{LLK_REPS}), {graph_ms} ms replayed as one CUDA graph, "
        f"{call_ms:.4f} ms a call with its upload and sync, "
        f"numpy {numpy_ms:.4f} ms; pop+con --DeviceLLK {llk_s:.2f}s, "
        f"{cli_evals} evaluations, FREEMIX {fm_dev} (numpy {fm}); solves "
        f"(NumPC 4): " + ", ".join(
            f"{k} {v['wall_s']:.2f}s, {v['evals']} evaluations, alpha "
            f"{v['alpha']:.6g}" for k, v in solves.items()))
    res["device_llk"] = dict(
        markers=int(est._counts.shape[0]), rel_err=errs, eval_ms=eval_ms,
        graph_ms=graph_ms, call_ms=call_ms, numpy_ms=numpy_ms, cli_s=llk_s,
        cli_evals=cli_evals, freemix=fm_dev, solves=solves)
    return res


# ------------------------------------------------------------- phase 7


# the sharded likelihood against the unsharded one: float32 sums in
# another order (the reference's mesh tolerance, tests/test_device_llk.py)
MESH_LLK_REL = 1e-5


def _rank_line(r: dict, run: str) -> str:
    x = r["runs"][run]
    peak = "not measured" if r["peak_bytes"] is None \
        else f"{r['peak_bytes'] / 2**30:.2f} GiB"
    return (f"rank {r['rank']}: loaded in {r['load_s']:.1f}s, whole "
            f"{x['wall_s']:.2f}s, stages {_stage_line(x['times'])}, "
            f"launches {x['launches']}, peak device memory {peak}")


def phase_mesh(work: Path, logf, seed: int, pairs: int,
               small_w: dict | None = None, prod_w: dict | None = None,
               program: dict | None = None,
               pipeline: dict | None = None, dev: str = "cuda") -> dict:
    """The mesh: ranks that share the card (parallel/mesh.spawn, gloo
    collectives on host copies), the kernel and native libraries built
    before any rank starts.  dev: every rank's device ("cpu" rehearses
    the phase with the plain versions)."""
    import torch

    from fastquick_tpu_torch import qc_program as qp
    from fastquick_tpu_torch.kernels import build
    from fastquick_tpu_torch.parallel.mesh import spawn
    from fastquick_tpu_torch.pop.device_llk import DeviceLLK
    from fastquick_tpu_torch.pop.estimator import ContaminationEstimator
    from fastquick_tpu_torch.pop.pileup import read_pileup_file
    from fastquick_tpu_torch.testing import mesh_cases, popcon_cases
    from fastquick_tpu_torch.testing.synthworld import (
        build_production_world,
        build_synth_pe_world,
    )

    build.cuda_library()  # no rank compiles: they load these builds
    qp.build_native()
    torch.cuda.empty_cache()
    d = work / "mesh"
    d.mkdir()
    res: dict = {}
    with contextlib.redirect_stderr(logf):
        if small_w is None:
            (work / "small").mkdir(exist_ok=True)
            small_w = build_synth_pe_world(work / "small")
        if prod_w is None:
            (work / "prod").mkdir(exist_ok=True)
            prod_w = build_production_world(work / "prod", seed=seed,
                                            n_pairs=pairs)

    # ---- the small world: mesh-4 as 2 x 2 against mesh-2 ----
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(logf), contextlib.redirect_stdout(logf):
        dry = qp.dryrun_multichip(4, device=dev, world=small_w)
    wall = time.perf_counter() - t0
    for nd, ranks in dry["runs"].items():
        for r in ranks:
            layout = " (2 x 2)" if nd == 4 else ""
            log(f"mesh small world, mesh-{nd}{layout}, "
                f"{_rank_line(r, 'synth')}")
    log(f"mesh small world: mesh-4 (2 x 2) against mesh-2, "
        f"{2 * dry['runs'][4][0]['n_pairs']} reads, resident kernel, gloo "
        f"collectives: {len(dry['files'])} product files byte-identical "
        f"({dry['n_mapped']} mapped, {dry['n_pair_reads']} proper-pair "
        f"reads); {wall:.1f}s with the ranks' start and loads")
    res["small"] = dict(wall_s=wall, ranks={
        nd: [dict(load_s=r["load_s"], peak_bytes=r["peak_bytes"],
                  **{k: r["runs"]["synth"][k]
                     for k in ("wall_s", "times", "launches")})
             for r in ranks] for nd, ranks in dry["runs"].items()})

    # ---- production: mesh-2 run_with_fill against one device ----
    runs = [dict(name="resident", kernel="resident", fill=True,
                 opts=dict(pool=QC_POOL, chain=QC_CHAIN,
                           step_cap=QC_CAP_PER_BASE * 160)),
            dict(name="scan", kernel="scan", fill=True,
                 opts=dict(pool=512, chain=1, step_cap=768))]
    spec = dict(tmp=str(prod_w["tmp"]), idx_prefix=prod_w["idx_prefix"],
                fq1=prod_w["fq1"], fq2=prod_w["fq2"], device=dev, L=160,
                bitmaps=True, pileup_cap=64, engine="native",
                check_kernels=True, runs=runs)
    single = {}
    if program is not None:
        for run in runs:
            with open(program[run["name"]]["saved"], "rb") as fh:
                single[run["name"]] = pickle.load(fh)
    else:  # phase 5 did not run: the single-device runs here
        (d / "single").mkdir()
        with contextlib.redirect_stderr(logf):
            one = qp.mesh_job(None, dict(spec, out_dir=str(d / "single")))
        torch.cuda.empty_cache()
        single = one["runs"]
    (d / "prod").mkdir()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(logf):
        ranks = spawn(qp.mesh_job, 2, (dict(spec, out_dir=str(d / "prod")),))
    wall = time.perf_counter() - t0
    res["production"] = dict(wall_s=wall, ranks=[])
    for r in ranks:
        res["production"]["ranks"].append(dict(
            rank=r["rank"], load_s=r["load_s"], peak_bytes=r["peak_bytes"],
            runs={k: {f: v[f] for f in ("wall_s", "times", "launches",
                                        "fallback_first", "sweeps_held",
                                        "accumulations_held")}
                  for k, v in r["runs"].items()}))
    for run in runs:
        name = run["name"]
        a, b = ranks[0]["runs"][name], ranks[1]["runs"][name]
        one = single[name]
        for r in ranks:
            x = r["runs"][name]
            need = ("width", "search_chain" if name == "resident" else "scan",
                    "drand48")
            # on the CPU (a rehearsal) the wrappers launch nothing
            if dev == "cuda" and not all(x["launches"][k] for k in need):
                raise AssertionError(f"mesh production {name}, rank "
                                     f"{r['rank']} launched {x['launches']}")
            if int(x["stats"]["n_fallback"]):
                raise AssertionError(f"mesh production {name}: fallback "
                                     "reads left after the fill pass")
            held = x["sweeps_held"]
            if not held or (dev == "cuda"
                            and len(held) != x["launches"]["pairing"]):
                raise AssertionError(f"mesh production {name}, rank "
                                     f"{r['rank']}: {len(held)} sweeps held "
                                     f"to plain, {x['launches']['pairing']} "
                                     "pairing launches")
            acc_held = x["accumulations_held"]
            # each accumulation on the card: one walk, one order launch
            if dev == "cuda" and (not acc_held or any(
                    x["launches"][k] != len(acc_held)
                    for k in ("accumulate", "pileup"))):
                raise AssertionError(f"mesh production {name}, rank "
                                     f"{r['rank']}: {len(acc_held)} "
                                     f"accumulations held, launches "
                                     f"{x['launches']}")
            log(f"mesh production, {name} kernel, {_rank_line(r, name)}; "
                f"first pass {x['fallback_first']} fallback reads; its "
                f"{len(held)} pairing sweeps ((pairs, k_occ, cnt_chg): "
                f"{held}) equal to plain in every output and cnt_chg; its "
                f"{len(acc_held)} accumulations, a walk of the grid and an "
                f"order launch each ((B, L, marker_base's largest offset): "
                f"{acc_held}), equal to plain in every output")
        qp.same_run((a["stats"], a["rows"]), (b["stats"], b["rows"]),
                    f"mesh production {name}: rank 1 against rank 0")
        # n_reads counts padding rows; the production batch has none, but
        # the bar is the reference's
        qp.same_run((one["stats"], one["rows"]), (a["stats"], a["rows"]),
                    f"mesh production {name} against one device",
                    skip=("n_reads",))
        n_files = qp.same_files(one["files"], a["files"],
                                f"mesh production {name} against one device")
        log(f"mesh production, {name} kernel: mesh-2 run_with_fill over "
            f"{2 * ranks[0]['n_pairs']} reads equal to the single-device run "
            f"in every accumulator, n_pcr_dup, row and _drand_state; "
            f"{n_files} product files byte-identical")
    log(f"mesh production: both runs {wall:.1f}s with the ranks' start and "
        "loads")

    # ---- the sharded likelihood: 2 ranks on phase 6's pileup ----
    if pipeline is not None:
        svd, pile, fm_np = (pipeline["panel"], pipeline["pileup"],
                            pipeline["freemix"])
        what = "phase 6's production panel and pileup"
    else:  # phase 6 did not run: a seeded panel and a simulated pileup
        svd = popcon_cases.write_panel(str(d / "panel.vcf"), seed=seed)
        _cli(["pop+con", "--RefVCF", svd], logf)
        pile = popcon_cases.simulate_pileup(svd, str(d / "s.Pileup"),
                                            seed=seed, alpha_true=0.1)
        _cli(["pop+con", "--DisableSanityCheck", "--PileupFile", pile,
              "--SVDPrefix", svd, "--Output", str(d / "numpy")], logf)
        fm_np = _freemix(str(d / "numpy"))
        what = "a seeded panel and a simulated pileup"
    est = popcon_cases.estimator_from_files(
        ContaminationEstimator, read_pileup_file, svd, pile)
    est._prepare()
    llk = DeviceLLK(est._counts, est._UD_act, est._means_act, device=dev)
    want = [llk(pc, pc, a) for pc, a in LLK_POINTS]
    case = dict(svd=svd, pileup=pile, device=dev, points=LLK_POINTS,
                cli=str(d / "llk"), reps=LLK_REPS)
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(logf), contextlib.redirect_stdout(logf):
        ranks = spawn(mesh_cases.llk_case, 2, (case,))
    wall = time.perf_counter() - t0
    errs = []
    for r, got in enumerate(ranks):
        if not got["cli_sharded"]:
            raise AssertionError(f"rank {r}: pop+con --DeviceLLK ran "
                                 "unsharded")
        for g, w in zip(got["values"], want):
            errs.append(abs(g - w) / abs(w))
        fm = _freemix(got["cli_prefix"])
        if abs(fm - fm_np) > 5e-3:
            raise AssertionError(f"rank {r}: sharded --DeviceLLK FREEMIX "
                                 f"{fm} against numpy's {fm_np}")
    if max(errs) > MESH_LLK_REL:
        raise AssertionError(f"sharded DeviceLLK against unsharded: rel "
                             f"{max(errs)}")
    log(f"mesh DeviceLLK on {what}: {ranks[0]['markers']} markers over 2 "
        f"ranks, rel err against the unsharded DeviceLLK at the 3 points "
        f"{['%.2e' % e for e in errs[:3]]} (<= {MESH_LLK_REL}); a call "
        + ", ".join(f"rank {r} {g['call_ms']:.4f} ms" for r, g in
                    enumerate(ranks))
        + " (host clock, the gloo sum included); pop+con --DeviceLLK "
        + ", ".join(f"rank {r} {g['cli_s']:.2f}s FREEMIX "
                    f"{_freemix(g['cli_prefix'])}" for r, g in
                    enumerate(ranks))
        + f" (numpy {fm_np}); {wall:.1f}s with the ranks' start")
    res["device_llk"] = dict(source=what, markers=ranks[0]["markers"],
                             rel_err=errs, wall_s=wall,
                             call_ms=[g["call_ms"] for g in ranks],
                             cli_s=[g["cli_s"] for g in ranks],
                             freemix=[_freemix(g["cli_prefix"])
                                      for g in ranks], freemix_numpy=fm_np)
    return res


# ------------------------------------------------------------- phase 8

# the bench phase's cut sizes: reads, stream, one timed pass
BENCH_ENV = {"FQ_BENCH_READS": "4096", "FQ_BENCH_STREAM": "32768",
             "FQ_BENCH_REPS": "1", "FQ_SWEEP_READS": "4096",
             "FQ_SWEEP_REPS": "1"}
# the sweep's configs, and the kernel each must launch
SWEEP_CONFIGS = {"1024,1024,1": "search", "1024,1024,4": "search_chain",
                 "1024,512,1,32,scan": "scan"}


def _entry(argv: list[str], env: dict, name: str) -> list[dict]:
    """One benchmark entry point in a process of its own: its JSON lines
    (stderr to <name>.log beside the other logs); raises unless it exits
    0 and every line names this card."""
    import torch

    t0 = time.perf_counter()
    with open(OUT / f"{name}.log", "w") as err:
        r = subprocess.run([sys.executable, "-m"] + argv, cwd=REPO,
                           env=dict(os.environ, **BENCH_ENV, **env),
                           stdout=subprocess.PIPE, stderr=err, text=True,
                           timeout=600)
    lines = [json.loads(ln) for ln in r.stdout.splitlines()
             if ln.startswith("{")]
    if r.returncode != 0 or not lines:
        raise AssertionError(f"{name} exited {r.returncode}: {r.stdout}")
    for line in lines:
        nulls = [k for k, v in line.items() if v is None]
        if nulls or line["device"]["name"] != torch.cuda.get_device_name(0):
            raise AssertionError(f"{name}: {line}")
    log(f"bench {name} ({time.perf_counter() - t0:.1f}s): "
        + " | ".join(json.dumps(ln) for ln in lines))
    return lines


def phase_bench() -> dict:
    def launched(counts: dict, *kernels) -> None:
        if not all(counts.get(k) for k in kernels):
            raise AssertionError(f"launched {counts}, not all of {kernels}")

    res = {}
    (res["default"],) = _entry(["fastquick_tpu_torch.bench"], {}, "bench")
    launched(res["default"]["cuda_launches"], "width", "search")
    (res["cuda"],) = _entry(["fastquick_tpu_torch.bench"],
                            {"FQ_BENCH_ENGINE": "cuda"}, "bench_cuda")
    launched(res["cuda"]["launches"], "width", "search")
    (res["e2e"],) = _entry(["fastquick_tpu_torch.bench"],
                           {"FQ_BENCH_ENGINE": "e2e"}, "bench_e2e")
    res["sweep"] = _entry(["fastquick_tpu_torch.sweep", *SWEEP_CONFIGS], {},
                          "sweep")
    for line in res["sweep"]:
        if not line["ok"]:
            raise AssertionError(f"sweep {line}")
        launched(line["launches"], "width", SWEEP_CONFIGS[line["config"]])
    return res


# ----------------------------------------------------------------- main


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma list of kernels,small,production,program,"
                    "pipeline,mesh,bench "
                    "(the card phase always runs); the kernels and ok lines "
                    "are printed only when all of them ran")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pairs", type=int, default=100_000,
                    help="read pairs of the production world")
    args = ap.parse_args()
    phases = args.phases.split(",")

    if not (REPO / "fastquick_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: no GPU to run on",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    OUT.mkdir(parents=True, exist_ok=True)
    (REPO / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=REPO / "build"))
    result: dict = {}
    try:
        with open(OUT / "align.log", "w") as logf:
            result["card"] = phase_card()
            if "kernels" in phases:
                result["kernels"] = phase_kernels(args.seed)
            if "small" in phases:
                result["small"] = phase_small(work, logf)
            if "production" in phases:
                result["production"] = phase_production(
                    work, logf, args.seed, args.pairs)
            if "program" in phases:
                result["program"] = phase_program(
                    work, logf, args.seed, args.pairs,
                    result.get("small", {}).get("world"),
                    result.get("production", {}).get("world"))
            if "pipeline" in phases:
                result["pipeline"] = phase_pipeline(
                    work, logf, args.seed, args.pairs,
                    result.get("small", {}).get("world"),
                    result.get("production", {}).get("world"))
            if "mesh" in phases:
                result["mesh"] = phase_mesh(
                    work, logf, args.seed, args.pairs,
                    result.get("small", {}).get("world"),
                    result.get("production", {}).get("world"),
                    result.get("program"),
                    result.get("pipeline", {}).get("production"))
            if "bench" in phases:
                result["bench"] = phase_bench()
    finally:
        shutil.rmtree(work, ignore_errors=True)
        (OUT / "result.json").write_text(json.dumps(result, indent=1,
                                                   default=str))

    if set(ALL_PHASES) - set(phases):
        # the kernels and ok lines carry numbers of every phase
        log(f"partial run ({args.phases}): no kernels or ok line")
        return 0
    prod = result["production"]
    program = result["program"]["resident"]["launches"]
    launches = dict(prod["launches"], scan=prod["scan"]["launches"]["scan"],
                    search_chain=program["search_chain"],
                    drand48=program["drand48"], pairing=program["pairing"],
                    accumulate=program["accumulate"],
                    pileup=program["pileup"])
    missing = [k for k in KERNELS if not launches.get(k)]
    if missing:
        raise AssertionError(f"main path launched no {missing} kernel")
    line = []
    for name, (src, tpu) in KERNELS.items():
        k = result["kernels"][name]
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": tpu, "launches": launches[name],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": line}), flush=True)
    card = result["card"]
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["kind"], "count": card["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
