"""Device full QC step: inexact search + the complete StatCollector
accumulator set in one step over a read batch.

Counterpart of fastquick_tpu/ops/qc_full.py (the mesh wrapper around the
step is parallel/mesh.make_sharded_qc_full_step).  The reference's
align+stats core (src/StatCollector.cpp AddSingleAlignment :424-621 and
the accumulator fields of src/StatCollector.h:70-119) as one program:

  k-mer filter -> width + inexact FM search (the CUDA width and resident
  search kernels, or the scan kernel) -> SE hit selection (the drand48
  reservoir draw, a CUDA kernel) -> approx mapQ -> SA positions ->
  [paired-end: isize inference, pairing, pair status] -> per-base
  accumulation over the covered (B, L) grid and marker pileups in read
  order.

Accumulators produced (integer tensors, int32 as in the reference):

  dense site space (S,):  depth, q20, q30
  histograms:             emp_rep/mis_emp_rep (256), emp_cycle/
                          mis_emp_cycle (256)
  marker pileups (M,CAP): packed per-marker entries (base/qual/mapq/
                          strand/cycle) in global read order
  counters:               n_reads, n_filtered, n_mapped, n_eligible,
                          n_base_mapped, n_gapped, n_fallback, n_xy,
                          pileup_ovf

Semantics notes (as in the reference package):
  - hit selection runs the reference's drand48 reservoir draw when
    opt_args["drand48"] is set; otherwise deterministic first-best-hit.
  - only ungapped primary hits feed the per-base accumulators.
  - reads the search kernel could not finish (pool/step caps) are counted
    in n_fallback and excluded, unless `fb_fill` carries their host-exact
    hit lists (qc_program.run_with_fill).
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import numpy as np
import torch

from ..align.opts import G_LOG_N
from ..utils.device import resolve_device
from ..utils.spans import span
from .accumulate import (  # noqa: F401  (re-exported as the reference's)
    _pileup_ranks,
    accumulate,
    accumulate_pileup,
    pileup,
    ragged_unreverse,
)
from .drand48_device import aln2seq_draw_scan, seed_state
from .fm import DeviceFM
from .kmer import filter_reads
from .pe_device import (
    expand_occurrences,
    infer_isize_from_hist,
    isize_hist_local,
    pair_status,
    pairing_sweep,
    pairing_work,
)
from .search_kernels import A_MAX, SearchParams, resident_search, scan_chunk
from .batch_search import read_inputs
from .site_tables import SiteTables, build_site_tables

__all__ = ["PILEUP_CAP", "SiteTables", "build_site_tables", "unpack_entry",
           "synthetic_site_tables", "ragged_unreverse", "se_select",
           "pack_host_hits", "pack_pe_fill", "qc_step_full",
           "count_pcr_dups", "local_pileup_counts"]

PILEUP_CAP = 64  # per-marker pileup slots (device tensor width)
_i32 = torch.int32
_i64 = torch.long


def unpack_entry(v: np.ndarray):
    """Host-side unpack -> (base, qual, mapq, strand, cycle)."""
    v = np.asarray(v)
    return ((v >> 1) & 7, (v >> 4) & 127, (v >> 11) & 127,
            (v >> 18) & 1, (v >> 19) & 1023)


def synthetic_site_tables(text: np.ndarray, n_markers: int = 8,
                          flank: int = 250, seed: int = 0,
                          device: str | torch.device = "cuda") -> SiteTables:
    """Standalone tables over a synthetic text (tests / entry): markers
    evenly spaced, each with a +/-flank in-region window, every position
    of which is a dense site; every 3rd site dbsnp.  `seed` is unused,
    as in the reference.  On the card unless `device` is "cpu" (cuda
    without CUDA raises)."""
    device = resolve_device(device)
    n = len(text)
    mpos = np.linspace(flank, n - flank - 1, n_markers).astype(np.int64)
    site_idx = np.full(n + 1, -1, np.int32)
    marker_id = np.full(n + 1, -1, np.int32)
    nxt = 0
    for mi, mp in enumerate(mpos):
        span = np.arange(mp - flank, mp + flank + 1)
        fresh = site_idx[span] < 0
        site_idx[span[fresh]] = nxt + np.arange(int(fresh.sum()))
        nxt += int(fresh.sum())
        marker_id[mp] = mi
    S = nxt
    is_xy = np.zeros(n + 1, bool)
    is_xy[: n // 8] = True
    contig_id = np.full(n + 1, -1, np.int32)
    bounds = np.linspace(0, n, n_markers + 1).astype(np.int64)
    for mi in range(n_markers):
        contig_id[bounds[mi]:bounds[mi + 1]] = mi
    return SiteTables.from_numpy(
        site_idx, marker_id, np.concatenate([text.astype(np.int32), [4]]),
        (np.arange(S) % 3) == 0, is_xy, contig_id, bounds[:-1],
        np.diff(bounds), S, n_markers, device)


def _approx_mapq(c1, c2, mm_eq_max):
    """bwa_approx_mapQ (bwase.c:102-111), vectorized."""
    g = torch.tensor(G_LOG_N, dtype=_i64, device=c2.device)[c2.clamp(0, 255)]
    q = torch.where(c2 == 0, 37, torch.where(23 < g, 0, 23 - g))
    q = torch.where(mm_eq_max, 25, q)
    q = torch.where(c1 > 1, 0, q)
    return torch.where(c1 == 0, 23, q)


def se_select(n_aln, alns, draw=None):
    """SE selection from the kernel's ordered hit list (packed rows
    [mm|go<<6|ge<<12|a<<18|score<<19, k, l]): best class widths ->
    (mapped, strand, row, c1, c2, n_mm, n_gapo, n_gape).  c1/c2 match
    bwa_aln2seq_core.  The within-class pick is the reference's drand48
    reservoir draw when `draw` = (f0_sel, row_sel) from
    ops/drand48_device.aln2seq_draw_scan is given; otherwise the
    deterministic first best hit at interval offset 0."""
    A = alns.shape[1]
    n_aln = n_aln.long()
    used = torch.arange(A, device=alns.device)[None, :] < n_aln[:, None]
    a0 = alns[:, :, 0].long()
    score = (a0 >> 19) & 127
    width = torch.where(used, alns[:, :, 2].long() - alns[:, :, 1] + 1, 0)
    best = torch.where(n_aln > 0, score[:, 0], -1)
    in_best = used & (score == best[:, None])
    c1 = torch.where(in_best, width, 0).sum(1)
    c2 = torch.where(used & ~in_best, width, 0).sum(1)
    mapped = n_aln > 0
    if draw is not None:
        f0, row = draw[0].long(), draw[1].long()
    else:
        f0, row = a0[:, 0], alns[:, 0, 1].long()
    return (mapped, (f0 >> 18) & 1, row, c1, c2,
            f0 & 63, (f0 >> 6) & 63, (f0 >> 12) & 63)


def pack_host_hits(reads, rows_idx, B, A_MAX_=A_MAX):
    """Pack host-engine hit lists into the kernel's (B, A_MAX, 3) form
    for `qc_step_full(fb_fill=...)`: fb_n[b] = -1 marks rows without a
    fill; packed rows are [mm|go<<6|ge<<12|a<<18|score<<19, k, l] in the
    engine's recording order (identical to the kernel's)."""
    fb_n = np.full(B, -1, np.int32)
    fb_rows = np.zeros((B, A_MAX_, 3), np.int32)
    for p, b in zip(reads, rows_idx):
        fb_n[b] = min(len(p.aln), A_MAX_)
        for j, a in enumerate(p.aln[:A_MAX_]):
            fb_rows[b, j, 0] = (a.n_mm | (a.n_gapo << 6) | (a.n_gape << 12)
                                | (a.a << 18) | (a.score << 19))
            fb_rows[b, j, 1] = a.k
            fb_rows[b, j, 2] = a.l
    return fb_n, fb_rows


def pack_pe_fill(pairs, pair_idx, P):
    """Pack host-rescued/refined pair ends for qc_step_full(pe_fill=...).

    pairs: [(p0, p1)] Read objects AFTER align.pe.bwa_paired_sw (and
    refine); pair_idx: their pair-row indices in the device batch.  The
    device pair statuses and accumulators then carry the post-rescue/
    refine positions."""
    from ..align.dp import FROM_D, FROM_M, FROM_S
    from ..align.pe import BWA_TYPE_NO_MATCH, SAM_FPP

    fill = {"mask": np.zeros(P, np.int32)}
    for f in ("pos", "strand", "mapq", "seq_q", "n_mm", "n_gapo",
              "n_gape", "proper", "mapped", "cl_l", "cl_r", "span"):
        fill[f + "0"] = np.zeros(P, np.int32)
        fill[f + "1"] = np.zeros(P, np.int32)
    for (p0, p1), i in zip(pairs, pair_idx):
        fill["mask"][i] = 1
        for j, p in ((0, p0), (1, p1)):
            fill[f"pos{j}"][i] = p.pos
            fill[f"strand{j}"][i] = p.strand
            fill[f"mapq{j}"][i] = p.mapQ
            fill[f"seq_q{j}"][i] = p.seQ
            fill[f"n_mm{j}"][i] = p.n_mm
            fill[f"n_gapo{j}"][i] = p.n_gapo
            fill[f"n_gape{j}"][i] = p.n_gape
            fill[f"proper{j}"][i] = 1 if (p.extra_flag & SAM_FPP) else 0
            fill[f"mapped{j}"][i] = 1 if p.type != BWA_TYPE_NO_MATCH \
                else 0
            # soft-clip widths (rescued ends): the host collector's
            # pos - cl_left insert arithmetic + no-clip dup gate
            fill[f"span{j}"][i] = p.len
            if p.cigar:
                if p.cigar[0][0] == FROM_S:
                    fill[f"cl_l{j}"][i] = p.cigar[0][1]
                if p.cigar[-1][0] == FROM_S:
                    fill[f"cl_r{j}"][i] = p.cigar[-1][1]
                fill[f"span{j}"][i] = sum(
                    ln for op, ln in p.cigar if op in (FROM_M, FROM_D))
    return fill


class _Stages:
    """The step's stages: each runs in a span of its name (utils/spans.py)
    and, when `times` is given, adds its wall time (s) to times under that
    name, the card synced at every stage boundary so that a stage's
    kernels count in it.  A stage opened inside another (a mesh's
    exchange) counts in its own time, not its parent's."""

    def __init__(self, times: dict | None, dev: torch.device):
        self.times, self.dev = times, dev
        self.open: list[str] = []
        self.t = 0.0

    def _charge(self) -> None:
        """The time since the last boundary, to the innermost open stage."""
        if self.times is None:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        t = time.perf_counter()
        if self.open:
            name = self.open[-1]
            self.times[name] = self.times.get(name, 0.0) + t - self.t
        self.t = t

    @contextmanager
    def __call__(self, name: str):
        with span(name):
            self._charge()
            self.open.append(name)
            try:
                yield
            finally:
                self._charge()
                self.open.pop()


def search_params(opt_args: dict, L: int) -> SearchParams:
    """The search parameters qc_step_full takes from opt_args (the
    reference's defaults: pool 256, chain 4, step cap 64 * L)."""
    return SearchParams(
        L=L, SL=int(opt_args.get("seed_len", 32)),
        NP=int(opt_args.get("pool", 256)),
        step_cap=int(opt_args.get("step_cap", 64 * L)), s_mm=3, s_gapo=11,
        s_gape=4, max_gapo=int(opt_args.get("max_gapo", 1)),
        max_gape=int(opt_args.get("max_gape", 6)), indel_end_skip=5,
        max_del_occ=10, max_entries=2000000,
        max_top2=int(opt_args.get("max_top2", 30)),
        max_seed_diff=int(opt_args.get("max_seed_diff", 2)),
        CH=int(opt_args.get("chain", 4)))


def qc_step_full(fm_arrays: DeviceFM, tables: SiteTables, opt_args: dict,
                 seqs, rseqs, quals, lens,
                 bitmaps=None, thresh: int = 3,
                 pileup_cap: int = PILEUP_CAP,
                 marker_base: torch.Tensor | None = None,
                 md_table: torch.Tensor | None = None,
                 return_per_read: bool = False,
                 pair_mode: bool = False,
                 last_ii: torch.Tensor | None = None,
                 last_drand: torch.Tensor | None = None,
                 fb_fill: tuple | None = None,
                 pe_fill: dict | None = None,
                 kernel: str = "resident",
                 times: dict | None = None,
                 counts: dict | None = None,
                 mesh=None, axis_names: tuple = ()):
    """One batch's full QC step on the tensors' device.

    fm_arrays: the index as the port's DeviceFM (the reference takes its
    arrays as a dict).  seqs: (B, L) reversed codes; rseqs: (B, L)
    revcomp codes (both as stored by bwa's seq_reverse); quals: (B, L)
    phred in read orientation; lens: (B,).  marker_base: (M,) per-marker
    slot offset for this batch's pileup entries (0 when None).

    kernel: "resident" (the resident search kernel, the reference's
    choice with its packed FM table) or "scan" (the scan kernel, the
    counterpart of the reference's XLA lockstep path; chain 1 only, with
    opt_args["lanes"] lanes, default 1024).

    fb_fill: optional (fb_n (B,), fb_rows (B, A_MAX, 3)) host-exact hit
    lists for kernel-fallback reads (pack_host_hits).  Filled reads are
    treated as device-finished: the drand48 stream then consumes their
    draws in order.  pe_fill: pack_pe_fill's dict (tensors).  times: a
    dict that receives each stage's wall time in seconds ("search",
    "drand48", "se_mapq", and in pair mode "pairing", "second_pass",
    "pair_status"; then "accumulate"; on a mesh also "exchange"); each
    stage also runs in a span of that name (utils/spans.py).  counts: a
    dict that receives the step's work as device scalars, for its
    rooflines: under "search", the rows searched, the launches, the busy
    steps and the hit rows (with L, seed_len and the FM table's bytes:
    utils/bounds.search_bound's inputs); under "pairing", each sweep's
    pe_device.pairing_work (utils/bounds.pairing_bound's).

    mesh, axis_names: one shard's step of parallel/mesh.
    make_sharded_qc_full_step (every rank the same B rows; axis_names
    innermost first, as the reference's).  Three exchanges inside the
    step keep it equal to one device's step on the whole batch: the
    drand48 draw runs over the gathered hit lists of the batch and keeps
    this rank's rows, the insert-size histogram is summed (its max length
    maxed) before the estimate, and the second pairing pass's budget
    counts pairs in global read order.  Empty: the single-device step."""
    B, L = seqs.shape
    dev = seqs.device
    n_text = int(opt_args["n_text"])
    stage = _Stages(times, dev)
    lens = lens.long()

    with stage("search"):
        if bitmaps is not None:  # on the forward codes, ragged-correct
            kept = filter_reads(bitmaps, ragged_unreverse(seqs, lens), lens,
                                thresh)
        else:
            kept = torch.ones(B, dtype=torch.bool, device=dev)
        if md_table is not None:  # per-read maxdiff (bwa_cal_maxdiff by len)
            md_of_len = md_table.long()[lens.clamp(0, md_table.shape[0] - 1)]
        else:
            md_of_len = torch.full((B,), int(opt_args["max_diff"]),
                                   dtype=_i64, device=dev)
        md = torch.where(kept, md_of_len, -1)
        seed_len = int(opt_args.get("seed_len", 32))
        use_seed = (lens > seed_len) if opt_args.get("use_seed", True) \
            else torch.zeros(B, dtype=torch.bool, device=dev)
        P = search_params(opt_args, L)
        if kernel == "scan" and P.CH != 1:
            raise ValueError("pallas scan path supports chain=1 only")
        if kernel not in ("resident", "scan"):
            raise ValueError(f"unknown search kernel {kernel!r}")
        # the search takes the rows it searches (md >= 0) as one dense
        # chunk: a row it skips would idle a scan lane for good
        # (search_kernels.scan_chunk), and a skipped row's results are
        # zeros either way
        real = (md >= 0).nonzero()[:, 0]
        n_aln = torch.zeros(B, dtype=_i64, device=dev)
        alns = torch.zeros((B, A_MAX, 3), dtype=_i32, device=dev)
        fallback = torch.zeros(B, dtype=_i64, device=dev)
        busy = hit_rows = 0
        if real.numel():
            inp = read_inputs(fm_arrays, seqs[real], lens[real], md[real],
                              use_seed[real], P)
            if kernel == "scan":
                out = scan_chunk(fm_arrays, P,
                                 int(opt_args.get("lanes", 1024)),
                                 int(opt_args.get("inner", 16)), **inp)
            else:
                out = resident_search(fm_arrays, P, **inp)
            del inp
            n_aln[real] = out[0].long()
            alns[real] = out[1]
            fallback[real] = out[2].long()
            if counts is not None:  # the scan counts its busy steps itself
                busy = out[5] if kernel == "scan" else out[3].long().sum()
                hit_rows = out[0].long().clamp(0, A_MAX).sum()
            del out
        if counts is not None:
            counts["search"] = dict(
                rows=int(real.numel()), launches=int(real.numel() > 0),
                busy_steps=busy, hit_rows=hit_rows, L=P.L, seed_len=P.SL,
                table_bytes=fm_arrays.kernel_table_bytes())
        if fb_fill is not None:
            fb_n, fb_rows = (torch.as_tensor(x, device=dev) for x in fb_fill)
            has_fill = (fallback != 0) & (fb_n >= 0)
            n_aln = torch.where(has_fill, fb_n.long(), n_aln)
            alns = torch.where(has_fill[:, None, None],
                               fb_rows.to(alns.dtype), alns)
            fallback = torch.where(has_fill, 0, fallback)

    draw = None
    drand_state = None
    with stage("drand48"):
        if opt_args.get("drand48", False):
            # the reference drand48 reservoir selection (bwase.c:19-44): one
            # global stream in read order
            state0 = last_drand if last_drand is not None \
                else torch.as_tensor(
                    seed_state(int(opt_args.get("drand_seed", 11))),
                    device=dev)
            g_n, g_alns = n_aln, alns
            if axis_names:
                with stage("exchange"):
                    for ax in axis_names:  # gathered outermost last
                        g_n = mesh.all_gather(g_n, ax)
                        g_alns = mesh.all_gather(g_alns, ax)
            f0, row_d, drand_state = aln2seq_draw_scan(
                g_n.reshape(-1), g_alns.reshape(-1, A_MAX, 3), state0)
            if axis_names:
                base = mesh.shard_index(axis_names[::-1]) * B
                f0, row_d = f0[base: base + B], row_d[base: base + B]
            draw = (f0, row_d)

    with stage("se_mapq"):
        mapped, strand, row, c1, c2, n_mm, n_gapo, n_gape = se_select(
            n_aln, alns, draw=draw)
        mapped = mapped & kept & (fallback == 0)
        mapq = _approx_mapq(c1, c2, n_mm == md_of_len)
        # SA row -> pac pos: strand 1 reads the forward SA; strand 0
        # converts through the reverse index
        row_c = row.clamp(0, n_text)
        sa = fm_arrays.sa
        pos = torch.where(strand == 1, sa[0][row_c].long(),
                          n_text - (sa[1][row_c].long() + lens))

    pair_acc = {}
    if pair_mode:
        pair_acc, mapped, pos, strand, mapq, n_gapo, n_gape = _pair_mode(
            fm_arrays, tables, opt_args, n_text, n_aln, alns, lens, mapped,
            pos, strand, mapq, n_mm, n_gapo, n_gape, last_ii, pe_fill,
            stage, mesh, axis_names, counts)

    with stage("accumulate"):
        gapped = mapped & ((n_gapo > 0) | (n_gape > 0))
        eligible = mapped & (mapq >= 20) & ~gapped
        acc = _accumulate(tables, n_text, seqs, rseqs, quals, lens,
                          eligible, pos, strand, mapq, pileup_cap,
                          marker_base)
        acc.update({
            "n_reads": torch.tensor(B, dtype=_i32, device=dev),
            "n_filtered": _count(~kept),
            "n_mapped": _count(mapped),
            "n_eligible": _count(eligible),
            "n_gapped": _count(gapped),
            "n_fallback": _count(fallback != 0),
            "n_xy": _count(eligible & tables.is_xy[pos.clamp(0, n_text)]),
        })
        if drand_state is not None:
            acc["_drand_state"] = drand_state  # stream continuation state
        acc.update(pair_acc)
    if not return_per_read:
        return acc
    # per-read flags for the driver: which reads the host must redo
    # exactly -- kernel overflows, plus gapped primaries (host refine)
    per_read = {
        "kept": kept,
        "mapped": mapped,
        "eligible": eligible,
        "fallback": fallback.to(_i32),
        "host_redo": kept & ((fallback != 0)
                             | (mapped & gapped & (mapq >= 20))),
    }
    return acc, per_read


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum().to(_i32)


def _pair_mode(fm, tables, opt_args, n_text, n_aln, alns, lens, mapped,
               pos, strand, mapq, n_mm, n_gapo, n_gape, last_ii, pe_fill,
               stage, mesh, axis_names, counts=None):
    """The reference's PE semantics on the batch (rows (2i, 2i+1) are
    mates): isize inference from SE mapQ (bwape.c:55), the pairing sweep
    and its second pass over the pairs the k_occ cap truncated, the pe_fill
    injection, the contig-overhang demotion and the pair statuses.  On a
    mesh (axis_names), the histogram is summed over the ranks and the
    second pass's budget counts pairs in global read order.  counts: a
    dict that receives each sweep's work (pe_device.pairing_work) as a
    list under "pairing", or None.
    Returns (pair accumulators, and mapped, pos, strand, mapq, n_gapo,
    n_gape after pairing)."""
    dev = pos.device
    sa = fm.sa
    g_log_n = torch.tensor(G_LOG_N, dtype=_i64, device=dev)
    k_occ = int(opt_args.get("k_occ", 32))
    ap_prior = float(opt_args.get("ap_prior", 1e-5))
    max_isize = int(opt_args.get("max_isize", 500))
    s_mm = int(opt_args.get("s_mm", 3))

    def half(x, j):
        return x[j::2]

    se = [dict(pos=half(pos, j), strand=half(strand, j), mapq=half(mapq, j),
               seq_q=half(mapq, j), n_mm=half(n_mm, j),
               n_gapo=half(n_gapo, j), n_gape=half(n_gape, j),
               len=half(lens, j)) for j in (0, 1)]
    mapped0, mapped1 = half(mapped, 0), half(mapped, 1)

    with stage("pairing"):
        hist, mlen = isize_hist_local(
            se[0]["pos"], se[1]["pos"], se[0]["len"], se[1]["len"],
            se[0]["mapq"], se[1]["mapq"], mapped0 & mapped1)
        if axis_names:
            with stage("exchange"):
                for ax in axis_names:  # the chip level first
                    hist = mesh.psum(hist, ax)
                    mlen = mesh.pmax(mlen, ax)
        ii = infer_isize_from_hist(hist, mlen, ap_prior, n_text,
                                   last_ii=last_ii)

        alns0, alns1 = alns[0::2], alns[1::2]
        occ0 = expand_occurrences(sa, n_text, half(n_aln, 0), alns0,
                                  se[0]["len"], k_occ)
        occ1 = expand_occurrences(sa, n_text, half(n_aln, 1), alns1,
                                  se[1]["len"], k_occ)
        occ_fit = (occ0["n_occ"] <= k_occ) & (occ1["n_occ"] <= k_occ)
        pair_ok = mapped0 & mapped1 & occ_fit
        out0, out1, cnt_chg = pairing_sweep(occ0, occ1, alns0, alns1,
                                            se[0], se[1], pair_ok, ii, s_mm,
                                            max_isize, g_log_n)
        if counts is not None:
            counts["pairing"] = [pairing_work(occ0, occ1, alns0, alns1,
                                              pair_ok, ii)]

    with stage("second_pass"):
        # second-phase expansion: pairs the k_occ cap truncated re-expand at
        # k_occ2 and re-run the sweep, up to ovf_cap pairs in read order
        k_occ2 = int(opt_args.get("k_occ2", 512))
        ovf_cap = int(opt_args.get("ovf_cap", 64))
        fits2 = (occ0["n_occ"] <= k_occ2) & (occ1["n_occ"] <= k_occ2)
        ovf_pair = mapped0 & mapped1 & ~occ_fit & fits2
        # the budget counts pairs in global read order, so a mesh run picks
        # the pairs one device's run picks: the lower ranks' counts come first
        base = 0
        if axis_names:
            g_cnt = ovf_pair.sum().to(_i32)
            with stage("exchange"):
                for ax in axis_names:
                    g_cnt = mesh.all_gather(g_cnt, ax)
                base = int(g_cnt.reshape(-1)[: mesh.shard_index(
                    axis_names[::-1])].sum())
        rank = base + torch.cumsum(ovf_pair.long(), 0) - 1
        within = ovf_pair & (rank < ovf_cap)
        n_within = int(within.sum())
        # with no pair within, the pass would change nothing: its writes all
        # drop and it finds no pair, so its cnt_chg is 0
        if n_within:
            sel = within.nonzero()[:, 0]  # (n_within,) in read order
            a0s, a1s = alns0[sel], alns1[sel]
            se0s = {kk: vv[sel] for kk, vv in se[0].items()}
            se1s = {kk: vv[sel] for kk, vv in se[1].items()}
            occ0b = expand_occurrences(sa, n_text, half(n_aln, 0)[sel], a0s,
                                       se0s["len"], k_occ2)
            occ1b = expand_occurrences(sa, n_text, half(n_aln, 1)[sel], a1s,
                                       se1s["len"], k_occ2)
            live = torch.ones(n_within, dtype=torch.bool, device=dev)
            out0b, out1b, cnt_chgb = pairing_sweep(
                occ0b, occ1b, a0s, a1s, se0s, se1s, live, ii, s_mm,
                max_isize, g_log_n)
            if counts is not None:
                counts["pairing"].append(pairing_work(occ0b, occ1b, a0s, a1s,
                                                      live, ii))
            for f in out0:
                out0[f] = out0[f].clone()
                out1[f] = out1[f].clone()
                out0[f][sel] = out0b[f].to(out0[f].dtype)
                out1[f][sel] = out1b[f].to(out1[f].dtype)
            cnt_chg = cnt_chg + cnt_chgb

    with stage("pair_status"):
        fmask = None
        if pe_fill is not None:
            pe_fill = {k: torch.as_tensor(v, device=dev) for k, v in
                       pe_fill.items()}
            fmask = pe_fill["mask"] != 0
            for j, out in ((0, out0), (1, out1)):
                for f in ("pos", "strand", "mapq", "seq_q", "n_mm", "n_gapo",
                          "n_gape"):
                    out[f] = torch.where(fmask, pe_fill[f"{f}{j}"].long(),
                                         out[f].long())
                out["proper"] = torch.where(
                    fmask, pe_fill[f"proper{j}"] != 0, out["proper"])
                zcl = torch.zeros_like(out["pos"])
                for f in ("cl_l", "cl_r"):
                    out[f] = torch.where(fmask, pe_fill[f"{f}{j}"].long(),
                                         zcl)
                # cigar reference span (sum of M/D) for the demotion
                out["span"] = torch.where(fmask, pe_fill[f"span{j}"].long(),
                                          out["len"].long())

        def ileave(a0, a1):
            return torch.stack([a0.long(), a1.long()], 1).reshape(-1)

        pos = ileave(out0["pos"], out1["pos"])
        strand = ileave(out0["strand"], out1["strand"])
        mapq = ileave(out0["mapq"], out1["mapq"])
        n_gapo = ileave(out0["n_gapo"], out1["n_gapo"])
        n_gape = ileave(out0["n_gape"], out1["n_gape"])
        span_il = lens
        if fmask is not None:
            # a rescued previously-unmapped end becomes mapped
            fmask2 = torch.stack([fmask, fmask], 1).reshape(-1)
            fmap = torch.stack([pe_fill["mapped0"] != 0,
                                pe_fill["mapped1"] != 0], 1).reshape(-1)
            mapped = torch.where(fmask2, fmap, mapped)
            span_il = torch.where(fmask2, ileave(out0["span"], out1["span"]),
                                  lens)

        # contig-overhang demotion (AddAlignment, StatCollector.cpp:725-734)
        C = tables.contig_off.shape[0]
        cid = tables.contig_id[pos.clamp(0, n_text)].long()
        offv = tables.contig_off[cid.clamp(0, C - 1)].long()
        clnv = tables.contig_len[cid.clamp(0, C - 1)].long()
        mapped = mapped & (cid >= 0) & (pos + span_il - offv <= clnv)
        mapped0, mapped1 = half(mapped, 0), half(mapped, 1)

        ps = pair_status(tables.contig_id, tables.contig_off,
                         tables.contig_len, n_text, out0, out1, mapped0,
                         mapped1)
        i32 = lambda x: x.to(_i32)  # noqa: E731
        pair_acc = {
            "isize_dist": ps["isize_dist"],
            "pair_status_counts": ps["status_counts"],
            "n_pair_reads": ps["n_pair_reads"],
            "n_pair_cnt_chg": i32(cnt_chg),
            "n_pair_ovf": _count(mapped0 & mapped1 & ~occ_fit & ~within),
            "_pair_keys": ps["dup_keys"],
            "_ii": ii,
            "_isize_hist": hist,
            "_isize_maxlen": mlen,
            "_pair_rows": {
                "status": ps["status"], "actual": ps["actual"],
                "mi": ps["mi"], "mi2": ps["mi2"],
                "cid_p": ps["cid_p"], "cid_q": ps["cid_q"],
                "pos0": i32(out0["pos"]), "pos1": i32(out1["pos"]),
                "strand0": i32(out0["strand"]), "strand1": i32(out1["strand"]),
                "mapq0": i32(out0["mapq"]), "mapq1": i32(out1["mapq"]),
                "len0": i32(out0["len"]), "len1": i32(out1["len"]),
                "proper": out0["proper"],
                "mapped0": mapped0, "mapped1": mapped1,
                "n_mm0": i32(out0["n_mm"]), "n_mm1": i32(out1["n_mm"]),
                "n_gapo0": i32(out0["n_gapo"]), "n_gapo1": i32(out1["n_gapo"]),
                "n_gape0": i32(out0["n_gape"]), "n_gape1": i32(out1["n_gape"]),
                "seq_q0": i32(out0["seq_q"]), "seq_q1": i32(out1["seq_q"]),
            },
        }
    return pair_acc, mapped, pos, strand, mapq, n_gapo, n_gape


def _accumulate(tables, n_text, seqs, rseqs, quals, lens, eligible, pos,
                strand, mapq, pileup_cap, marker_base):
    """The per-base accumulators over the covered (B, L) grid and the
    marker pileups in read order (ops/accumulate): on the card one walk of
    the grid for both (accumulate_pileup), on the CPU the plain versions
    through accumulate and pileup."""
    if seqs.is_cuda:
        return accumulate_pileup(tables, n_text, seqs, rseqs, quals, lens,
                                 eligible, pos, strand, mapq, pileup_cap,
                                 marker_base)
    acc = accumulate(tables, n_text, seqs, rseqs, quals, lens, eligible, pos,
                     strand)
    n_base = acc.pop("n_base_mapped")
    acc.update(pileup(tables, n_text, seqs, rseqs, quals, lens, eligible,
                      pos, strand, mapq, pileup_cap, marker_base))
    acc["n_base_mapped"] = n_base
    return acc


def count_pcr_dups(keys: torch.Tensor) -> torch.Tensor:
    """num_pcr_dup from a (K, 3) multiset of (contig, start, end)
    pac-coordinate pair keys (0x7FFFFFFF sentinel rows = no proper pair).
    Every repeat of a key beyond its first occurrence counts 2 reads (the
    reference's duplicate_table adds 2 per already-seen insert signature,
    StatCollector.cpp:698-704); the count depends only on the multiset."""
    real = keys[keys[:, 0] != 0x7FFFFFFF]
    n_unique = torch.unique(real, dim=0).shape[0] if real.shape[0] else 0
    return torch.tensor(2 * (real.shape[0] - n_unique), dtype=_i32,
                        device=keys.device)


def local_pileup_counts(tables: SiteTables, opt_args, fm_arrays,
                        seqs, rseqs, quals, lens, bitmaps=None,
                        thresh: int = 3, kernel: str = "resident"):
    """This batch's per-marker entry counts (the mesh wrapper exchanges
    them for cross-shard slot offsets before the accumulation pass)."""
    out = qc_step_full(fm_arrays, tables, opt_args, seqs, rseqs, quals,
                       lens, bitmaps=bitmaps, thresh=thresh, kernel=kernel)
    return out["pileup_cnt"]
