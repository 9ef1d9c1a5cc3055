"""Batched inexact FM search engine with an exact host redo of fallbacks.

Counterpart of fastquick_tpu/ops/batch_search.py:834-1113 (BatchEngine).
A chunk of reads goes to the device as nibble-packed reversed codes plus
one [len, md, use_seed] aux array; there:

1. the width kernel computes bwt_cal_width for both strands of every read
   and of its seed (ops/search_kernels.width);
2. a search kernel runs bwt_match_gap for every read: by default the
   resident kernel, one launch per chunk (ops/search_kernels.
   resident_search); with ``FQ_BS_PALLAS=2`` the scan kernel, B
   persistent lanes advanced K_INNER steps a round with the lanes' flush
   and refill between rounds, also one launch per chunk (ops/
   search_kernels.scan_chunk);
3. ``compact_hits`` packs the hit rows densely, so only about one row per
   read comes back to the host.

Reads the kernel cannot finish within its bounds (pool, score buckets,
A_MAX hits, step cap, compacted-buffer size) carry FB_* cause bits and are
redone by the exact native (or host) engine on a thread, so every result
is exact.  That redo is part of the algorithm; it is counted and reported
with its causes.  A kernel failure raises: there is no retry on another
path.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from ..align.core import Aln
from ..align.opts import GapOpt, bwa_cal_maxdiff
from ..align.sample_setup import exact_engine
from ..index.builder import ReducedIndex
from ..utils.bounds import search_bytes
from ..utils.device import resolve_device
from ..utils.spans import span
from .fm import DeviceFM, width_finalize
from .search_kernels import (
    A_MAX,
    FB_D2H,
    FB_LONG,
    FB_NAMES,
    NBUCK,
    SearchParams,
    resident_search,
    scan_chunk,
    width,
)

# ldp (a read position) is packed into the diff word above bit 18 and
# unpacked with an arithmetic `d >> 18`: longer reads take the host engine
MAX_READ_LEN = 8191


def search_kernel(device_type: str, pallas=None) -> str:
    """The search kernel a BatchEngine on ``device_type`` runs: "resident"
    or "scan".  ``pallas`` as the reference's BatchEngine takes it (None =
    ``FQ_BS_PALLAS``: 1 = resident, the default; 2 = scan; True = scan;
    "resident" / "scan").  0 / False selects the reference's XLA lockstep
    path, which has no kernel of its own in the port: on cuda it raises; on
    the CPU it is the scan path, whose plain version is that path's step
    loop and outer round."""
    if pallas is None:
        pallas = int(os.environ.get("FQ_BS_PALLAS", 1))
    if pallas is True:
        pallas = 2
    kernel = {1: "resident", 2: "scan", "resident": "resident",
              "scan": "scan"}.get(pallas)
    if kernel is not None:
        return kernel
    if pallas not in (0, False):
        raise ValueError(f"unknown search kernel selection {pallas!r} "
                         "(FQ_BS_PALLAS: 1 = resident, 2 = scan)")
    if device_type != "cpu":
        raise RuntimeError(
            "FQ_BS_PALLAS=0: the XLA lockstep search path is not ported to "
            "the GPU; use 1 (resident kernel) or 2 (scan kernel)")
    return "scan"


def compact_hits(n_aln: torch.Tensor, alns: torch.Tensor, fb: torch.Tensor,
                 K_CAP: int):
    """Dense (K_CAP, 3) hit-row buffer + per-read offsets from the
    (N, A_MAX, 3) hit tensor.  Reads whose rows would spill past K_CAP are
    flagged FB_D2H (and redone exactly on the host)."""
    N = n_aln.shape[0]
    dev = n_aln.device
    n_eff = torch.where(fb != 0, 0, n_aln.clamp(max=A_MAX)).long()
    ends = torch.cumsum(n_eff, 0)
    offs = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                      ends[:-1]])
    total = ends[-1].clamp(max=K_CAP)
    j = torch.arange(K_CAP, dtype=torch.long, device=dev)
    read = torch.searchsorted(ends, j, right=True)
    read_c = read.clamp(0, N - 1)
    hit = j - offs[read_c]
    rows = alns[read_c, hit.clamp(0, A_MAX - 1)]
    rows = torch.where((j < total)[:, None], rows, 0)
    spill = (ends > K_CAP) & (n_eff > 0)
    fb = fb | torch.where(spill, FB_D2H, 0).to(fb.dtype)
    n_out = torch.where(spill, 0, n_eff)
    return n_out, rows, offs, fb


def pack_chunk(todo, opt: GapOpt, pool: int, step_cap: int = 0,
               kernel: str = "resident", chain: int = 1):
    """Host half of one chunk: the padded, nibble-packed reversed codes
    (Npad a power of two >= 256, Lpad a multiple of 32), the [len, md,
    use_seed] aux rows (md = -1 marks padding) and the chunk's search
    parameters (step_cap 0 = auto: max(1536, 6 * Lpad) for the resident
    kernel, max(768, 3 * Lpad) for the scan kernel; chain: the chain
    length CH).  Returns (packed (Npad, Lpad/2) uint8, aux (Npad, 3)
    int32, SearchParams)."""
    B = len(todo)
    Lmax = max(p.len for p in todo)
    Npad = 256
    while Npad < B:
        Npad *= 2
    Lpad = max(32, -(-Lmax // 32) * 32)
    seqs = np.full((Npad, Lpad), 4, dtype=np.int8)
    lens = np.zeros(Npad, dtype=np.int32)
    md = np.full(Npad, -1, dtype=np.int32)
    use_seed = np.zeros(Npad, dtype=bool)
    for b, p in enumerate(todo):
        seqs[b, : p.len] = p.seq[: p.len]
        lens[b] = p.len
        md[b] = (bwa_cal_maxdiff(p.len, thres=opt.fnr)
                 if opt.fnr > 0.0 else opt.max_diff)
        use_seed[b] = p.len > opt.seed_len
    batch_md = int(md[:B].max())
    P = SearchParams(
        L=Lpad, SL=opt.seed_len, NP=int(pool),
        step_cap=int(step_cap or (max(1536, 6 * Lpad) if kernel == "resident"
                                  else max(768, 3 * Lpad))),
        s_mm=opt.s_mm, s_gapo=opt.s_gapo, s_gape=opt.s_gape,
        max_gapo=int(min(opt.max_gapo, batch_md)),
        max_gape=opt.max_gape, indel_end_skip=opt.indel_end_skip,
        max_del_occ=opt.max_del_occ, max_entries=opt.max_entries,
        max_top2=opt.max_top2, max_seed_diff=opt.max_seed_diff,
        CH=int(chain))
    packed = (seqs[:, 0::2].astype(np.uint8)
              | (seqs[:, 1::2].astype(np.uint8) << 4))
    aux = np.stack([lens, md, use_seed.astype(np.int32)], axis=1)
    return packed, aux, P


def chunk_inputs(fm: DeviceFM, packed: torch.Tensor, aux: torch.Tensor,
                 P: SearchParams) -> dict:
    """Device inputs of the search kernel for one chunk (read_inputs) from
    its packed form.

    packed: (Npad, L/2) uint8 nibble pairs of reversed codes (lo = even
    position); aux: (Npad, 3) int32 [len, md, use_seed]."""
    pk8 = packed.long()
    seqs0 = torch.stack([pk8 & 15, (pk8 >> 4) & 15], 2).reshape(
        pk8.shape[0], -1)
    return read_inputs(fm, seqs0, aux[:, 0].long(), aux[:, 1].long(),
                       aux[:, 2] != 0, P)


def read_inputs(fm: DeviceFM, seqs0: torch.Tensor, lens: torch.Tensor,
                md: torch.Tensor, use_seed: torch.Tensor,
                P: SearchParams) -> dict:
    """Device inputs of the search kernel for N reads: their codes and
    per-read scalars and the width rows of both strands of every read and
    of its seed (two width-kernel launches).

    seqs0: (N, L) reversed read codes (4 = N / padding); lens, md: (N,)
    (md < 0 marks a row the search skips); use_seed: (N,) bool."""
    N, L = seqs0.shape
    assert L == P.L, (L, P.L)
    seqs0 = seqs0.long()
    lens, md = lens.long(), md.long()
    dev = seqs0.device
    seq1 = torch.where(seqs0 < 4, 3 - seqs0, seqs0)
    units = torch.cat([seqs0, seq1])  # (2N, L): strand-0 rows first
    del seq1
    sel2 = torch.cat([torch.zeros(N, dtype=torch.int32, device=dev),
                      torch.ones(N, dtype=torch.int32, device=dev)])
    lens2 = torch.cat([lens, lens])
    SL = P.SL
    # seed widths over the last SL bases (only meaningful where use_seed)
    spos = ((lens - SL).clamp(0, L)[:, None]
            + torch.arange(SL, device=dev)[None, :]).clamp(0, L - 1)
    seed_units = torch.where(use_seed[:, None].repeat(2, 1),
                             units.gather(1, spos.repeat(2, 1)), 4)
    wv, bv = width(fm, units, sel2)
    del units
    widths = width_finalize(wv, bv, lens2)
    del wv, bv
    swv, sbv = width(fm, seed_units, sel2)
    seed_w = width_finalize(swv, sbv, torch.full_like(lens2, SL))
    n_n = ((seqs0 > 3) & (torch.arange(L, device=dev)[None, :]
                          < lens[:, None])).sum(1)
    return dict(seqs0=seqs0, lens=lens, md=md, use_seed=use_seed, n_n=n_n,
                widths=widths, seed_w=seed_w)


def search_chunk(fm: DeviceFM, packed: torch.Tensor, aux: torch.Tensor,
                 P: SearchParams, kernel: str = "resident", lanes: int = 0,
                 inner: int = 0):
    """The device half of one chunk: unpack, widths, search, compaction.
    ``lanes`` and ``inner`` are the scan kernel's lane count and steps a
    round.  Returns (meta (3 Npad,) [n_aln | offs | fb], rows (3 Npad, 3)
    on the device, busy steps (a device scalar), outer rounds (0 for the
    resident kernel, which has none), lane steps (the steps the lanes were
    held for: rounds x inner x lanes for the scan kernel; for the resident
    kernel, whose warps of 32 threads take 32 reads in order, each warp's
    longest read's steps x 32, a device scalar))."""
    N = packed.shape[0]
    inp = chunk_inputs(fm, packed, aux, P)
    if kernel == "scan":
        n_aln, alns, fb, steps, rounds, busy = scan_chunk(fm, P, lanes,
                                                          inner, **inp)
        lane_steps = rounds * inner * min(lanes, N)
    else:
        n_aln, alns, fb, steps = resident_search(fm, P, **inp)
        rounds, busy = 0, steps.long().sum()
        lane_steps = steps.long().reshape(-1, 32).amax(1).sum() * 32
    n_c, rows, offs, fb_c = compact_hits(n_aln, alns, fb, 3 * N)
    meta = torch.cat([n_c.to(torch.int32), offs.to(torch.int32), fb_c])
    return meta, rows, busy, rounds, lane_steps


class BatchEngine:
    """Batched device engine with an exact native/host redo of the reads
    the device search cannot finish.

    It runs on the card unless ``device`` is "cpu" (the plain versions);
    "cuda" without a usable CUDA device raises.  ``chain``: the resident
    kernel's chain length CH (exact-walk bases a step; None =
    ``FQ_BS_CHAIN``, default 1); the scan path walks one base a step and
    raises for any other."""

    def __init__(self, idx: ReducedIndex, device: str | torch.device = "cuda",
                 max_batch: int = 32768, lanes: int | None = None,
                 pool: int | None = None, inner: int | None = None,
                 step_cap: int | None = None, chain: int | None = None,
                 pallas=None):
        self.idx = idx
        # chosen before anything moves to the device (see search_kernel)
        self.kernel = search_kernel(torch.device(device).type, pallas)
        self.device = resolve_device(device)
        env = os.environ.get
        self.chain = chain or int(env("FQ_BS_CHAIN", 1))
        if self.kernel == "scan" and self.chain != 1:
            raise ValueError(f"chain {self.chain}: the scan kernel walks one "
                             "base a step (chain 1)")
        self.lanes = lanes or int(env("FQ_BS_LANES", 1024))
        self.inner = inner or int(env("FQ_BS_INNER", 32))
        # pool slots per read, 0 = per-kernel auto: the resident kernel's
        # fallback share falls off a cliff below ~1000 slots on real read
        # mixes; the scan path keeps the reference's 512
        self.pool = (pool or int(env("FQ_BS_POOL", 0))
                     or (1024 if self.kernel == "resident" else 512))
        # 0 = auto (pack_chunk)
        self.step_cap = (step_cap if step_cap is not None
                         else int(env("FQ_BS_STEPCAP", 0)))
        self.dev = DeviceFM.build(idx.fm_fwd, idx.fm_rev, self.device)
        self.host = exact_engine(idx)
        self.max_batch = max_batch
        self.last_fallback = 0
        self.last_busy = 0
        self.last_iters = 0  # rounds * inner, as the reference counts them
        self.last_lane_steps = 0  # steps the lanes were held (search_chunk)
        self.last_bytes = 0  # bytes the searches must move (utils/bounds)
        self.last_fb_causes: dict[str, int] = {}
        # totals over the engine's life
        self.reads_searched = 0
        self.reads_fallback = 0
        self.fb_causes: dict[str, int] = {}
        self.rounds = 0
        self.busy = 0

    def align_batch(self, reads, opt: GapOpt) -> None:
        todo = [p for p in reads if not p.filtered]
        for p in reads:
            p.sa = 0
            p.type = 0
            p.c1 = p.c2 = 0
            p.n_aln = 0
            p.aln = []
        self.last_fallback = 0
        self.last_busy = 0
        self.last_iters = 0
        self.last_lane_steps = 0
        self.last_bytes = 0
        self.last_fb_causes = {}
        for s in range(0, len(todo), self.max_batch):
            self._run_chunk(todo[s:s + self.max_batch], opt)
        self.reads_searched += len(todo)
        self.reads_fallback += self.last_fallback
        for k, v in self.last_fb_causes.items():
            self.fb_causes[k] = self.fb_causes.get(k, 0) + v

    def _count_causes(self, cause_words: np.ndarray) -> None:
        for bit, name in FB_NAMES.items():
            c = int(((cause_words & bit) != 0).sum())
            if c:
                self.last_fb_causes[name] = (
                    self.last_fb_causes.get(name, 0) + c)

    def _run_chunk(self, todo, opt: GapOpt) -> None:
        if not todo:
            return
        # diff-word fields are 6 bits: the NBUCK guard keeps counts at or
        # below (NBUCK-1)//penalty, which must fit in 63
        for pen in (opt.s_mm, opt.s_gapo, opt.s_gape):
            assert (NBUCK - 1) // max(pen, 1) <= 63, (
                f"penalty {pen} admits >63 events within {NBUCK} score "
                "buckets; diff-word packing would overflow")
        long_reads = [p for p in todo if p.len > MAX_READ_LEN]
        if long_reads:
            self.host.align_batch(long_reads, opt)
            self.last_fallback += len(long_reads)
            self.last_fb_causes[FB_NAMES[FB_LONG]] = (
                self.last_fb_causes.get(FB_NAMES[FB_LONG], 0)
                + len(long_reads))
            todo = [p for p in todo if p.len <= MAX_READ_LEN]
        if not todo:
            return
        B = len(todo)
        packed, aux, P = pack_chunk(todo, opt, self.pool, self.step_cap,
                                    self.kernel, self.chain)
        Npad = packed.shape[0]
        meta_d, rows_d, busy, rounds, lane_steps = search_chunk(
            self.dev, torch.from_numpy(packed).to(self.device),
            torch.from_numpy(aux).to(self.device), P, self.kernel,
            self.lanes, self.inner)
        meta = meta_d.cpu().numpy()  # [n_aln | offs | fallback]
        n_aln = meta[:Npad]
        offs = meta[Npad:2 * Npad]
        fallback = meta[2 * Npad:]
        self.last_fallback += int((fallback[:B] != 0).sum())
        self._count_causes(fallback[:B])
        self.last_busy += int(busy)
        self.last_iters += rounds * self.inner
        self.last_lane_steps += int(lane_steps)
        self.last_bytes += search_bytes(
            P, B, self.dev.kernel_table_bytes(),
            int(n_aln[:B].sum()), 3)
        self.busy += int(busy)
        self.rounds += rounds
        fb_list = fallback.tolist()
        fb_reads = [p for b, p in enumerate(todo) if fb_list[b]]
        # the exact redo overlaps the hit-row copy and decode (the native
        # engine releases the GIL)
        fb_thread = None
        if fb_reads:
            fb_thread = threading.Thread(
                target=self.host.align_batch, args=(fb_reads, opt))
            fb_thread.start()
        rows = rows_d.cpu().numpy()
        f0 = rows[:, 0]
        mm_l = (f0 & 63).tolist()
        go_l = ((f0 >> 6) & 63).tolist()
        ge_l = ((f0 >> 12) & 63).tolist()
        a_l = ((f0 >> 18) & 1).tolist()
        sc_l = ((f0 >> 19) & 127).tolist()
        k_l = rows[:, 1].tolist()
        l_l = rows[:, 2].tolist()
        n_list = n_aln.tolist()
        o_list = offs.tolist()
        for b, p in enumerate(todo):
            if fb_list[b]:
                continue
            s = o_list[b]
            p.aln = [Aln(mm_l[i], go_l[i], ge_l[i], a_l[i],
                         k_l[i], l_l[i], sc_l[i])
                     for i in range(s, s + n_list[b])]
            p.n_aln = len(p.aln)
        with span("search.redo_wait"):
            if fb_thread is not None:
                fb_thread.join()
