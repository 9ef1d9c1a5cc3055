"""Width and search kernels (CUDA, csrc/width.cu, csrc/search.cu and
csrc/scan.cu) with their plain PyTorch versions.

``width`` replaces the Pallas _width_kernel (fastquick_tpu/ops/
search_pallas.py:1603), ``resident_search`` the Pallas _resident_kernel
(:773) and ``scan_chunk`` the Pallas v1 scan kernel _kernel (:154) with
the outer round the reference ran around it.  Each wrapper launches its
CUDA kernel for CUDA tensors (and raises if that fails) and runs the plain
version for CPU tensors:

- width: ops/fm.cal_width_planes;
- search: ``search_plain`` below, a lockstep formulation over lanes of
  reads (PlainLanes) with per-lane point gather/scatter pool updates and
  lane refill.  Its per-step semantics are those of the reference
  package's XLA ``_search_kernel`` step (fastquick_tpu/ops/
  batch_search.py:342-775), which tests/test_search_pallas.py pins equal
  to the Pallas kernels;
- scan: ``scan_search``, the reference's outer round over a PlainLanes
  state, K_INNER of those same lockstep steps a round.  The kernel runs
  the whole chunk, rounds included, in one launch.

Per-read semantics do not depend on the lane a read runs in or on the
reads beside it (chunk-level parameters aside: max_gapo and the step cap
come from the whole chunk), which is what lets the CUDA kernels run one
thread per read or per lane.
"""

from __future__ import annotations

import ctypes
from dataclasses import astuple, dataclass

import numpy as np
import torch

from ..kernels import build
from .fm import DeviceFM, cal_width_planes, occ4_pair

A_MAX = 48  # max recorded hits per read
_INNER = 32  # plain version: lockstep steps between lane flush/refills
NBUCK = 128  # score buckets
STATE_M, STATE_I, STATE_D = 0, 1, 2

# fallback-cause bits (0 = no fallback; any nonzero routes the read to the
# exact native/host engine)
FB_POOL = 1       # pool capacity exceeded (free slots < children)
FB_SCORE = 2      # child score outside the NBUCK bucket range
FB_AMAX = 4       # more than A_MAX recorded hits
FB_STEPCAP = 8    # per-read step cap hit
# (16 is the reference resident kernel's round cap; one thread per read
# has no rounds, so the bit is never set here)
FB_LONG = 32      # read longer than MAX_READ_LEN (host-side gate)
FB_D2H = 64       # compacted hit buffer overflowed (K_CAP rows)
FB_NAMES = {FB_POOL: "pool", FB_SCORE: "score", FB_AMAX: "amax",
            FB_STEPCAP: "stepcap", FB_LONG: "long", FB_D2H: "d2h"}


@dataclass(frozen=True)
class SearchParams:
    """Chunk-level search parameters (order = csrc/search_body.cuh)."""

    L: int  # padded read length
    SL: int  # seed length
    NP: int  # pool slots per read
    step_cap: int
    s_mm: int
    s_gapo: int
    s_gape: int
    max_gapo: int
    max_gape: int
    indel_end_skip: int
    max_del_occ: int
    max_entries: int
    max_top2: int
    max_seed_diff: int
    CH: int = 1  # chain length: exact-walk bases a step (resident kernel)

    def to_array(self) -> np.ndarray:
        return np.array(astuple(self), dtype=np.int32)


# ---------------------------------------------------------------- width


def width(fm: DeviceFM, units: torch.Tensor, sel: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """bwt_cal_width raw (w, bid) planes for (M, L) units (codes 0..4) with
    per-unit strand selector sel (M,).  Returns two (M, L) int32 tensors;
    ops/fm.width_finalize adds the terminal entry."""
    if units.device.type == "cpu":
        return cal_width_planes(fm, sel, units)
    build.require_cuda(units, sel, fm.words)
    M, L = units.shape
    units8 = units.to(torch.uint8).contiguous()
    sel32 = sel.to(torch.int32).contiguous()
    w = torch.empty((M, L), dtype=torch.int32, device=units.device)
    bid = torch.empty((M, L), dtype=torch.int32, device=units.device)
    lib = build.cuda_library()
    hp = fm.host_params()
    stream = torch.cuda.current_stream(units.device).cuda_stream
    p = build.ptr
    rc = lib.fq_width_launch(p(fm.kernel_table()),
                             hp.ctypes.data_as(ctypes.c_void_p), p(units8),
                             p(sel32), M, L, p(w), p(bid),
                             ctypes.c_void_p(stream))
    build.check(rc, "width")
    build.launch_counts["width"] += 1
    return w, bid


# --------------------------------------------------------------- search


def _check_chunk(P: SearchParams, N: int, widths: torch.Tensor,
                 seed_w: torch.Tensor) -> None:
    """Raise on a chunk the search kernels do not take."""
    if not 0 < P.NP < 32768:
        raise ValueError(f"pool of {P.NP} slots: the next link is 15 bits")
    if (widths.shape != (2 * N, P.L + 1, 2) or widths.dtype != torch.int32
            or not widths.is_contiguous()):
        raise ValueError(f"widths must be contiguous int32 (2N, L+1, 2), "
                         f"got {widths.dtype} {tuple(widths.shape)}")
    if seed_w.shape != (2 * N, P.SL + 1, 2):
        raise ValueError(f"seed_w must be (2N, SL+1, 2), got "
                         f"{tuple(seed_w.shape)}")


def _kernel_inputs(seqs0, lens, md, use_seed, n_n, seed_w):
    """A chunk's per-read inputs in the types the search kernels take:
    uint8 codes, int32 scalars and seed width rows, contiguous."""
    i32 = torch.int32
    return (seqs0.to(torch.uint8).contiguous(),
            *(t.to(i32).contiguous() for t in (lens, md, use_seed, n_n)),
            seed_w.to(i32).contiguous())


def resident_search(fm: DeviceFM, P: SearchParams, seqs0: torch.Tensor,
                    lens: torch.Tensor, md: torch.Tensor,
                    use_seed: torch.Tensor, n_n: torch.Tensor,
                    widths: torch.Tensor, seed_w: torch.Tensor,
                    hwm: torch.Tensor | None = None, retry: bool = False):
    """Inexact search of a chunk of N reads.

    seqs0: (N, L) reversed read codes (strand 0; strand 1 is their
    complement); lens/md/use_seed/n_n: (N,) (md < 0 marks padding rows);
    widths: (2N, L+1, 2) finalized width rows (strand-0 rows first) --
    scratch: the CUDA kernel applies gap_shadow to it in place; seed_w:
    (2N, SL+1, 2).  hwm: an optional (N,) int32 tensor that receives each
    read's pool high-water mark (the most slots it held at once; 0 for a
    dead read).  retry: launch the kernel's retry entry
    (``fq_search_retry_kernel``, counted in ``launch_counts
    ["search_retry"]``), the same search under a name of its own.

    Returns (n_aln, alns (N, A_MAX, 3) [mm|go<<6|ge<<12|a<<18|score<<19,
    k, l], fb, steps), all int32, raw per read (n_aln is not zeroed for
    fallback reads)."""
    if seqs0.device.type == "cpu":
        return search_plain(fm, P, seqs0, lens, md, use_seed, n_n, widths,
                            seed_w, hwm=hwm)
    build.require_cuda(seqs0, lens, md, use_seed, n_n, widths, seed_w,
                       fm.words)
    N = seqs0.shape[0]
    dev = seqs0.device
    i32 = torch.int32
    _check_chunk(P, N, widths, seed_w)
    if hwm is None:
        hwm = torch.empty(N, dtype=i32, device=dev)
    elif (hwm.shape != (N,) or hwm.dtype != i32 or not hwm.is_cuda
          or not hwm.is_contiguous()):
        raise ValueError("hwm must be a contiguous (N,) int32 CUDA tensor")
    seqs8, lens32, md32, us32, nn32, seed32 = _kernel_inputs(
        seqs0, lens, md, use_seed, n_n, seed_w)
    pool = torch.empty((N, P.NP, 4), dtype=i32, device=dev)
    freel = torch.empty((N, P.NP), dtype=torch.int16, device=dev)
    alns = torch.zeros((N, A_MAX, 3), dtype=i32, device=dev)
    n_aln = torch.empty(N, dtype=i32, device=dev)
    fb = torch.empty(N, dtype=i32, device=dev)
    steps = torch.empty(N, dtype=i32, device=dev)
    lib = build.cuda_library()
    hp = fm.host_params()
    sp = P.to_array()
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = build.ptr
    launch = lib.fq_search_retry_launch if retry else lib.fq_search_launch
    rc = launch(
        p(fm.kernel_table()), hp.ctypes.data_as(ctypes.c_void_p),
        sp.ctypes.data_as(ctypes.c_void_p), p(seqs8), p(lens32), p(md32),
        p(us32), p(nn32), N, p(widths), p(seed32), p(pool), p(freel),
        p(alns), p(n_aln), p(fb), p(steps), p(hwm), ctypes.c_void_p(stream))
    build.check(rc, "search")
    build.launch_counts["search_retry" if retry else
                        "search_chain" if P.CH > 1 else "search"] += 1
    return n_aln, alns, fb, steps


def _g(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-row point gather t[b, idx[b]]."""
    return t.gather(1, idx[:, None])[:, 0]


def _n_ids(md: torch.Tensor) -> int:
    """Rows up to the chunk's last real read (md >= 0; later rows are
    padding)."""
    real = (md >= 0).nonzero()
    return int(real.max()) + 1 if real.numel() else 0


class PlainLanes:
    """Lane state of the plain search: one row per lane, over one chunk's
    inputs.  Each lane keeps its own copy of its read's codes and width rows
    (as the reference's lockstep path does), so ``widths`` is left
    unchanged.  Pool, head, free and hit planes carry one dummy column
    (index NP / NBUCK / A_MAX) that absorbs masked-off scatters."""

    PER_LANE = ("rid", "done", "ch_on", "use_s", "lns", "md0", "max_diff",
                "n_entries", "free_top", "best_score", "best_cnt", "n_aln",
                "overflow", "steps", "hwm", "ch", "pk", "pl", "pai", "pdiff",
                "heads", "freel", "al", "wid", "sw", "seq")

    def __init__(self, fm: DeviceFM, P: SearchParams, B: int, seqs0, lens,
                 md, use_seed, n_n, widths, seed_w):
        dev = seqs0.device
        N, L = seqs0.shape
        NP, SL = P.NP, P.SL
        lng = torch.long
        self.fm, self.P, self.N, self.L = fm, P, N, L
        seq_s0 = seqs0.long()
        self.seq_all = torch.stack(
            [seq_s0, torch.where(seq_s0 < 4, 3 - seq_s0, seq_s0)], 1)
        self.wid_all = torch.stack([widths[:N], widths[N:]], 1).long()
        self.sw_all = torch.stack([seed_w[:N], seed_w[N:]], 1).long()
        self.lens_all, self.md_all = lens.long(), md.long()
        self.us_all, self.nn_all = use_seed.bool(), n_n.long()
        self.n_ids = _n_ids(md)
        self.L2 = fm.L2.long()
        self.iota_np = torch.arange(NP - 1, -1, -1, dtype=lng, device=dev)
        self.pos_lw = torch.arange(L + 1, device=dev)[None, :]
        self.ar_amax = torch.arange(A_MAX, device=dev)[None, :]

        def z(*shape, dtype=lng):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.rid = torch.full((B,), -1, dtype=lng, device=dev)
        self.done = torch.ones(B, dtype=torch.bool, device=dev)
        self.ch_on = z(B, dtype=torch.bool)
        self.use_s = z(B, dtype=torch.bool)
        for name in ("lns", "md0", "max_diff", "n_entries", "free_top",
                     "best_score", "best_cnt", "n_aln", "overflow", "steps",
                     "hwm"):
            setattr(self, name, z(B))
        self.ch = z(B, 8)
        self.pk, self.pl, self.pai, self.pdiff = (z(B, NP + 1)
                                                  for _ in range(4))
        self.heads = torch.full((B, NBUCK + 1), -1, dtype=lng, device=dev)
        self.freel = z(B, NP + 1)
        self.al = z(B, A_MAX + 1, 3)
        self.wid = z(B, 2, L + 1, 2)
        self.sw = z(B, 2, SL + 1, 2)
        self.seq = z(B, 2, L)

    @property
    def B(self) -> int:
        return self.rid.shape[0]

    @property
    def hits(self) -> torch.Tensor:
        """(B, A_MAX, 3) hit rows of each lane."""
        return self.al[:, :A_MAX]

    def keep(self, idx: torch.Tensor) -> None:
        for name in self.PER_LANE:
            setattr(self, name, getattr(self, name)[idx])

    def fresh(self, li: torch.Tensor, r: torch.Tensor) -> None:
        """Start read r[j] in lane li[j] (the reference's
        ``fresh_lane_state``).  An id >= N or a padding row (md < 0) leaves
        the lane idle (rid -1, done); a dead read is done at once."""
        P, n, NP = self.P, self.fm.n, self.P.NP
        rc = r.clamp(0, self.N - 1)
        valid = (r < self.N) & (self.md_all[rc] >= 0)
        ln = torch.where(valid, self.lens_all[rc], 0)
        m0 = torch.where(valid, self.md_all[rc], 0)
        dead = ~valid | (self.nn_all[rc] > m0) | (ln <= 0)
        self.rid[li] = torch.where(valid, r, -1)
        self.lns[li] = ln
        self.md0[li] = m0
        self.max_diff[li] = m0
        self.use_s[li] = valid & self.us_all[rc]
        self.pk[li] = 0
        self.pl[li] = 0
        self.pl[li, 0] = n
        self.pl[li, 1] = n
        self.pai[li] = 0
        self.pai[li, 0] = ln | (NP << 16)
        self.pai[li, 1] = ln | (1 << 13)
        self.pdiff[li] = 0
        self.heads[li] = -1
        self.heads[li, 0] = torch.where(dead, -1, 1)
        self.freel[li, :NP] = self.iota_np
        self.free_top[li] = NP - 2
        self.n_entries[li] = torch.where(dead, 0, 2)
        self.hwm[li] = self.n_entries[li]
        self.best_score[li] = ((m0 + 1) * P.s_mm
                               + (P.max_gapo + 1) * P.s_gapo
                               + (P.max_gape + 1) * P.s_gape)
        self.best_cnt[li] = 0
        self.n_aln[li] = 0
        self.al[li] = 0
        self.wid[li] = self.wid_all[rc]
        self.sw[li] = self.sw_all[rc]
        self.seq[li] = self.seq_all[rc]
        self.ch_on[li] = False
        self.ch[li] = 0
        self.done[li] = dead
        self.overflow[li] = 0
        self.steps[li] = 0

    def refill(self, mask: torch.Tensor, ids: torch.Tensor) -> None:
        """Start read ids[b] in every lane b where mask (see fresh)."""
        li = mask.nonzero().squeeze(1)
        if li.numel():
            self.fresh(li, ids[li])

    def step(self) -> None:
        """One lockstep step of every lane (a lane that is done takes
        none): the reference's XLA ``inner_step``."""
        fm, P, B = self.fm, self.P, self.B
        NP, L, SL, n = P.NP, self.L, P.SL, fm.n
        LW, SLW = L + 1, SL + 1
        L2, dev = self.L2, self.rid.device
        avail = ~self.done
        work_chain = avail & self.ch_on
        can_pop = avail & ~self.ch_on & (self.n_entries > 0)
        done = self.done | (avail & ~self.ch_on & (self.n_entries == 0))
        hitcap = can_pop & (self.n_entries > P.max_entries)
        done = done | hitcap
        can_pop = can_pop & ~hitcap

        # ---- pop: head of the lowest non-empty bucket ----
        bucket = (self.heads[:, :NBUCK] >= 0).to(torch.int8).argmax(1)
        slot = _g(self.heads, bucket).clamp(0, NP - 1)
        k, l = _g(self.pk, slot), _g(self.pl, slot)
        ai_w, d = _g(self.pai, slot), _g(self.pdiff, slot)
        nxt_f = (ai_w >> 16) & 0x7FFF
        nxt = torch.where(nxt_f == NP, -1, nxt_f)
        self.heads.scatter_(
            1, torch.where(can_pop, bucket, NBUCK)[:, None], nxt[:, None])
        top = self.free_top.clamp(0, NP - 1)
        self.freel.scatter_(1, torch.where(can_pop, top, NP)[:, None],
                            slot[:, None])
        free_top = self.free_top + can_pop.long()
        n_entries = self.n_entries - can_pop.long()
        a = (ai_w >> 13) & 1
        i = ai_w & 0x1FFF
        state = (ai_w >> 14) & 3
        n_mm, n_gapo, n_gape = d & 63, (d >> 6) & 63, (d >> 12) & 63
        ldp = d >> 18
        stop = can_pop & (bucket > self.best_score + P.s_mm)
        done = done | stop
        alive = can_pop & ~stop
        m = self.max_diff - (n_mm + n_gapo) - n_gape
        alive = alive & (m >= 0)
        i2 = i - 1
        widf = self.wid.view(B, -1)

        def wget(p, f):
            return _g(widf, a * (LW * 2) + p.clamp(0, L) * 2 + f)

        ww_i2, wb_i2 = wget(i2, 0), wget(i2, 1)
        ww_i2m1, wb_i2m1 = wget(i2 - 1, 0), wget(i2 - 1, 1)
        alive = alive & ~((i > 0) & (m < wb_i2))
        hit_i0 = alive & (i == 0)
        start_chain = alive & (i > 0) & (m == 0)
        expand = alive & ~hit_i0 & ~start_chain

        # ---- shared rank queries ----
        ch = self.ch
        ck_k = torch.where(work_chain, ch[:, 0], k)
        ck_l = torch.where(work_chain, ch[:, 1], l)
        cur_a = torch.where(work_chain, ch[:, 3], a)
        sel = 1 - cur_a
        cnt_k, cnt_l = occ4_pair(fm, sel, ck_k - 1, ck_l)  # (B, 4) each
        L2row = L2[sel]

        # ---- chain step (bwt_match_exact_alt) ----
        chainish = work_chain | start_chain
        ch_i = torch.where(work_chain, ch[:, 2], i)
        seqf = self.seq.view(B, -1)
        cc = _g(seqf, cur_a * L + (ch_i - 1).clamp(0, L - 1))
        si = _g(seqf, a * L + i2.clamp(0, L - 1))
        ccl = cc.clamp(0, 3)
        L2c = _g(L2row, ccl)
        nk = L2c + _g(cnt_k, ccl) + 1
        nl = L2c + _g(cnt_l, ccl)
        ch_dead = chainish & ((cc > 3) | (nk > nl))
        ch_hit = chainish & ~ch_dead & (ch_i - 1 == 0)
        ch_cont = chainish & ~ch_dead & ~ch_hit
        new_ch = torch.stack(
            [nk, nl, ch_i - 1, cur_a,
             torch.where(start_chain, n_mm, ch[:, 4]),
             torch.where(start_chain, n_gapo, ch[:, 5]),
             torch.where(start_chain, n_gape, ch[:, 6]),
             torch.where(start_chain, ldp, ch[:, 7])], 1)
        ch = torch.where(chainish[:, None], new_ch, ch)
        # bases 2..CH of the walk (the reference's chain sub-steps): lanes
        # still walking advance one more base each, with their own ranks
        for _ in range(P.CH - 1):
            act = ch_cont
            if not bool(act.any()):
                break
            s_a = ch[:, 3]
            s_sel = 1 - s_a
            s_cnt_k, s_cnt_l = occ4_pair(fm, s_sel, ch[:, 0] - 1, ch[:, 1])
            s_cc = _g(seqf, s_a * L + (ch[:, 2] - 1).clamp(0, L - 1))
            s_ccl = s_cc.clamp(0, 3)
            s_L2c = _g(L2[s_sel], s_ccl)
            s_nk = s_L2c + _g(s_cnt_k, s_ccl) + 1
            s_nl = s_L2c + _g(s_cnt_l, s_ccl)
            adv = act & ~((s_cc > 3) | (s_nk > s_nl))
            s_hit = adv & (ch[:, 2] - 1 == 0)
            ch = torch.where(adv[:, None], torch.cat(
                [torch.stack([s_nk, s_nl, ch[:, 2] - 1], 1), ch[:, 3:]], 1),
                ch)
            ch_hit = ch_hit | s_hit
            ch_cont = adv & ~s_hit
        self.ch = ch
        self.ch_on = ch_cont

        # ---- hits ----
        hit = hit_i0 | ch_hit
        hk = torch.where(ch_hit, ch[:, 0], k)
        hl = torch.where(ch_hit, ch[:, 1], l)
        hmm = torch.where(ch_hit, ch[:, 4], n_mm)
        hgo = torch.where(ch_hit, ch[:, 5], n_gapo)
        hge = torch.where(ch_hit, ch[:, 6], n_gape)
        ha = torch.where(ch_hit, ch[:, 3], a)
        hldp = torch.where(ch_hit, ch[:, 7], ldp)
        score = hmm * P.s_mm + hgo * P.s_gapo + hge * P.s_gape
        first_hit = hit & (self.n_aln == 0)
        self.best_score = torch.where(first_hit, score, self.best_score)
        self.max_diff = torch.where(
            first_hit, torch.minimum(hmm + hgo + hge + 1, self.md0),
            self.max_diff)
        eq_best = hit & (score == self.best_score)
        top2b = hit & ~eq_best & (self.best_cnt > P.max_top2)
        self.best_cnt = self.best_cnt + torch.where(eq_best, hl - hk + 1, 0)
        done = done | top2b
        hit = hit & ~top2b
        dup = ((self.al[:, :A_MAX, 1] == hk[:, None])
               & (self.al[:, :A_MAX, 2] == hl[:, None])
               & (self.ar_amax < self.n_aln[:, None])).any(1)
        do_add = hit & ~((hgo > 0) & dup)
        sh = do_add.nonzero().squeeze(1)
        if sh.numel():
            # gap_shadow on the hit strand's width row (bwtgap.c:81-91)
            hs = ha[sh]
            planes = self.wid[sh, hs]  # (H, LW, 2)
            ww, wb = planes[..., 0], planes[..., 1]
            x = (hl - hk + 1)[sh][:, None]
            in_rng = self.pos_lw < hldp[sh][:, None]
            eqx = (ww == x) & in_rng
            jcum = eqx.long().cumsum(1)
            ww_new = torch.where(in_rng & (ww > x), ww - x,
                                 torch.where(eqx, n - jcum, ww))
            wb_new = torch.where(eqx, 1, wb)
            self.wid[sh, hs] = torch.stack([ww_new, wb_new], -1)
        add_m = do_add & (self.n_aln < A_MAX)
        overflow = self.overflow | torch.where(
            do_add & (self.n_aln >= A_MAX), FB_AMAX, 0)
        arow = torch.stack([hmm | (hgo << 6) | (hge << 12) | (ha << 18)
                            | (score << 19), hk, hl], 1)
        self.al[torch.arange(B, device=dev),
                torch.where(add_m, self.n_aln, A_MAX)] = arow
        self.n_aln = self.n_aln + add_m.long()

        # ---- expansion (bwtgap.c:150-214) ----
        occ_w = l - k + 1
        allow_diff = ~((i2 > 0) & (wb_i2m1 > m - 1))
        allow_m = ~((i2 > 0) & (wb_i2m1 == m - 1) & (wb_i2 == m - 1)
                    & (ww_i2m1 == ww_i2))
        msd = P.max_seed_diff - (n_mm + n_gapo) - n_gape
        ii = i2 - (self.lns - SL)
        swf = self.sw.view(B, -1)

        def sget(p, f):
            return _g(swf, a * (SLW * 2) + p.clamp(0, SL) * 2 + f)

        s1w, s1b = sget(ii - 1, 0), sget(ii - 1, 1)
        s2w, s2b = sget(ii, 0), sget(ii, 1)
        seed_on = self.use_s & (i2 > 0) & (ii > 0)
        allow_diff = allow_diff & ~(seed_on & (s1b > msd - 1))
        allow_m = allow_m & ~(seed_on & (s1b == msd - 1) & (s2b == msd - 1)
                              & (s1w == s2w))
        tmp = n_gapo + n_gape
        indel_ok = (expand & allow_diff & (i2 >= P.indel_end_skip + tmp)
                    & (self.lns - i2 >= P.indel_end_skip + tmp))
        ins_open = indel_ok & (state == STATE_M) & (n_gapo < P.max_gapo)
        ins_ext = indel_ok & (state == STATE_I) & (n_gape < P.max_gape)
        del_open = ins_open
        del_ext = (indel_ok & (state == STATE_D) & (n_gape < P.max_gape)
                   & ((n_gapo + n_gape < self.max_diff)
                      | (occ_w < P.max_del_occ)))
        allow_mm = expand & allow_diff & allow_m

        kk4 = L2row + cnt_k + 1
        ll4 = L2row + cnt_l
        cv, cs, ckk, cll, cai, cdf = [], [], [], [], [], []

        def child(mask, pi, kj, lj, pmm, pgo, pge, pst, pldp):
            cv.append(mask)
            cs.append(pmm * P.s_mm + pgo * P.s_gapo + pge * P.s_gape)
            ckk.append(kj)
            cll.append(lj)
            cai.append((pst << 14) | (a << 13) | pi)
            cdf.append(pmm | (pgo << 6) | (pge << 12) | (pldp << 18))

        child(ins_open | ins_ext, i2, k, l, n_mm, n_gapo + ins_open.long(),
              n_gape + ins_ext.long(), STATE_I, i2)
        for j in range(4):
            child((del_open | del_ext) & (kk4[:, j] <= ll4[:, j]), i2 + 1,
                  kk4[:, j], ll4[:, j], n_mm, n_gapo + del_open.long(),
                  n_gape + del_ext.long(), STATE_D, i2 + 1)
        for j in range(1, 5):
            if j == 4:
                mask_j = allow_mm | (expand & ~(allow_diff & allow_m)
                                     & (si < 4))
                is_mm = allow_mm & (si > 3)
            else:
                mask_j = allow_mm
                is_mm = torch.ones_like(allow_mm)
            cj = (si + j) & 3
            kj, lj = _g(kk4, cj), _g(ll4, cj)
            child(mask_j & (kj <= lj), i2, kj, lj,
                  n_mm + (mask_j & is_mm).long(), n_gapo, n_gape, STATE_M,
                  torch.where(is_mm, i2, ldp))
        valid = torch.stack(cv, 1)
        scores = torch.stack(cs, 1)
        total = valid.long().sum(1)
        bad_score = (valid & (scores >= NBUCK)).any(1)
        no_room = total > free_top
        ovf = (bad_score | no_room) & expand
        overflow = (overflow | torch.where(bad_score & expand, FB_SCORE, 0)
                    | torch.where(no_room & expand, FB_POOL, 0))
        done = done | ovf
        valid = valid & ~ovf[:, None]
        total = torch.where(ovf, 0, total)
        rank = valid.long().cumsum(1)
        slots = self.freel.gather(
            1, (free_top[:, None] - rank).clamp(0, NP - 1))
        self.free_top = free_top - total
        self.n_entries = n_entries + total
        self.hwm = torch.maximum(self.hwm, self.n_entries)
        # LIFO pushes in C order: each child links to its bucket's head
        for c in range(len(cv)):
            v = valid[:, c]
            sc = scores[:, c].clamp(0, NBUCK - 1)
            prev = _g(self.heads, sc)
            aiw = cai[c] | (torch.where(prev < 0, NP, prev) << 16)
            col = torch.where(v, slots[:, c], NP)[:, None]
            self.pk.scatter_(1, col, ckk[c][:, None])
            self.pl.scatter_(1, col, cll[c][:, None])
            self.pai.scatter_(1, col, aiw[:, None])
            self.pdiff.scatter_(1, col, cdf[c][:, None])
            self.heads.scatter_(1, torch.where(v, sc, NBUCK)[:, None],
                                slots[:, c:c + 1])

        # ---- per-read step cap -> exact fallback ----
        steps = self.steps + (~done).long()
        capped = ~done & (steps > P.step_cap)
        self.overflow = overflow | torch.where(capped, FB_STEPCAP, 0)
        self.done = done | capped
        self.steps = steps


def search_plain(fm: DeviceFM, P: SearchParams, seqs0, lens, md, use_seed,
                 n_n, widths, seed_w, lanes: int = 8192, hwm=None):
    """Plain version of the search kernel: all lanes advance one step in
    lockstep; every _INNER steps finished lanes are flushed and refilled
    with the next reads, and once no reads are left the lane set shrinks to
    the lanes still searching.  Same arguments and results as
    resident_search (``widths`` is left unchanged)."""
    dev = seqs0.device
    N = seqs0.shape[0]
    lng = torch.long
    out_n = torch.zeros(N, dtype=lng, device=dev)
    out_al = torch.zeros((N, A_MAX, 3), dtype=lng, device=dev)
    out_fb = torch.zeros(N, dtype=lng, device=dev)
    out_steps = torch.zeros(N, dtype=lng, device=dev)
    out_hwm = torch.zeros(N, dtype=lng, device=dev)
    s = PlainLanes(fm, P, max(1, min(lanes, N)), seqs0, lens, md, use_seed,
                   n_n, widths, seed_w)

    next_read = 0
    while True:
        flush = s.done & (s.rid >= 0)
        if bool(flush.any()):
            fl = flush.nonzero().squeeze(1)
            r = s.rid[fl]
            out_n[r] = s.n_aln[fl]
            out_al[r] = s.al[fl, :A_MAX]
            out_fb[r] = s.overflow[fl]
            out_steps[r] = s.steps[fl]
            out_hwm[r] = s.hwm[fl]
            s.rid[fl] = -1
        if next_read < N:
            free_lanes = s.done.nonzero().squeeze(1)[: N - next_read]
            if free_lanes.numel():
                r = torch.arange(next_read, next_read + free_lanes.numel(),
                                 device=dev)
                s.fresh(free_lanes, r)
                next_read += free_lanes.numel()
        else:
            live = (~s.done).nonzero().squeeze(1)
            if live.numel() == 0:
                break
            if 2 * live.numel() <= s.B:
                s.keep(live)  # only stragglers left: shrink the lane set
        for _ in range(_INNER):
            s.step()
    i32 = torch.int32
    if hwm is not None:
        hwm.copy_(out_hwm)
    return (out_n.to(i32), out_al.to(i32), out_fb.to(i32),
            out_steps.to(i32))


# ----------------------------------------------------------------- scan


def scan_search(fm: DeviceFM, P: SearchParams, lanes: PlainLanes,
                inner: int):
    """The plain version of the scan path over a PlainLanes state of one
    chunk: the reference's ``_search_kernel`` outer_body (fastquick_tpu/
    ops/batch_search.py:777-823) around K_INNER lockstep steps.

    Lanes start on reads 0..B-1.  Each round advances every lane ``inner``
    steps (a lane that is done takes none), flushes the lanes that are done
    and hold a read, and refills them in lane order with the next reads; a
    padding row or an id >= N leaves a lane idle for good.  Rounds go on
    while a lane is searching or reads remain.  Reads remain while the next
    id is below the last real row + 1, not N: every padding row idles one
    lane, so the reference's loop (to N) never ends when a chunk's padding
    rows outnumber its lanes; where it ends, both count the same rounds.
    The loop condition is a host sync a round.

    Returns (n_aln, alns, fb, steps) per read as resident_search does, the
    number of rounds and the busy steps (those of flushed lanes, a device
    scalar)."""
    N, B = lanes.N, lanes.B
    dev = lanes.rid.device
    i32 = torch.int32
    # row N takes the writes of lanes that do not flush
    out_n = torch.zeros(N + 1, dtype=i32, device=dev)
    out_al = torch.zeros((N + 1, A_MAX, 3), dtype=i32, device=dev)
    out_fb = torch.zeros(N + 1, dtype=i32, device=dev)
    out_steps = torch.zeros(N + 1, dtype=i32, device=dev)
    row = torch.arange(A_MAX, device=dev)[None, :, None]
    lanes.refill(torch.ones(B, dtype=torch.bool, device=dev),
                 torch.arange(B, device=dev))
    next_read = torch.tensor(min(B, N), device=dev)
    busy = torch.zeros((), dtype=torch.long, device=dev)
    rounds = 0
    while bool((~lanes.done).any() | (next_read < lanes.n_ids)):
        for _ in range(inner):
            lanes.step()
        flush = lanes.done & (lanes.rid >= 0)
        tgt = torch.where(flush, lanes.rid.long(), N)
        n_aln = lanes.n_aln
        out_n[tgt] = n_aln.to(i32)
        out_al[tgt] = torch.where(row < n_aln[:, None, None], lanes.hits,
                                  0).to(i32)
        out_fb[tgt] = lanes.overflow.to(i32)
        out_steps[tgt] = lanes.steps.to(i32)
        busy += torch.where(flush, lanes.steps.long(), 0).sum()
        rank = flush.long().cumsum(0)
        lanes.refill(flush, next_read + rank - 1)
        next_read = next_read + rank[-1]
        rounds += 1
    return out_n[:N], out_al[:N], out_fb[:N], out_steps[:N], rounds, busy


def scan_chunk(fm: DeviceFM, P: SearchParams, lanes: int, inner: int,
               seqs0: torch.Tensor, lens: torch.Tensor, md: torch.Tensor,
               use_seed: torch.Tensor, n_n: torch.Tensor,
               widths: torch.Tensor, seed_w: torch.Tensor):
    """The scan path of one chunk of N reads on min(lanes, N) lanes,
    ``inner`` steps a round.  Inputs as for resident_search (``widths`` is
    scratch: the CUDA kernel applies gap_shadow to it in place).

    For CPU tensors it runs scan_search over PlainLanes; for CUDA tensors
    it launches the scan kernel once for the whole chunk, rounds, flushes
    and refills included, or raises.  Returns what scan_search returns:
    (n_aln, alns, fb, steps), the rounds (read back once) and the busy
    steps (a device scalar).  The scan path walks one base a step, as the
    reference's scan kernel does: a chain length P.CH other than 1 raises."""
    if P.CH != 1:
        raise ValueError("pallas scan path supports chain=1 only")
    N = seqs0.shape[0]
    B = min(lanes, N)
    # a padding row below the last real one idles the lane it is refilled
    # into for good; with B of them no lane is left and the rounds never end
    n_idle = int((md[:_n_ids(md)] < 0).sum())
    if n_idle >= B:
        raise ValueError(f"{n_idle} padding rows (md < 0) among the chunk's "
                         f"reads would idle all {B} scan lanes: put padding "
                         "rows last")
    if seqs0.device.type == "cpu":
        return scan_search(fm, P, PlainLanes(fm, P, B, seqs0, lens, md,
                                             use_seed, n_n, widths, seed_w),
                           inner)
    build.require_cuda(seqs0, lens, md, use_seed, n_n, widths, seed_w,
                       fm.words)
    _check_chunk(P, N, widths, seed_w)
    lib = build.cuda_library()
    fit = lib.fq_scan_max_lanes()
    if fit < 0:
        raise RuntimeError(f"scan kernel occupancy query failed: CUDA error "
                           f"{-fit}")
    if not 0 < B <= fit:
        raise ValueError(f"{B} scan lanes: one launch runs 1 to {fit} lanes "
                         "(the lanes that fit the card at once)")
    dev = seqs0.device
    i32 = torch.int32
    seqs8, lens32, md32, us32, nn32, seed32 = _kernel_inputs(
        seqs0, lens, md, use_seed, n_n, seed_w)
    pool = torch.empty((B, P.NP, 4), dtype=i32, device=dev)
    freel = torch.empty((B, P.NP), dtype=torch.int16, device=dev)
    alns = torch.zeros((N, A_MAX, 3), dtype=i32, device=dev)
    n_aln = torch.zeros(N, dtype=i32, device=dev)
    fb = torch.zeros(N, dtype=i32, device=dev)
    steps = torch.zeros(N, dtype=i32, device=dev)
    sync = torch.zeros(2 * B, dtype=i32, device=dev)
    stats = torch.zeros(2, dtype=torch.long, device=dev)  # rounds, busy
    hp = fm.host_params()
    sp = P.to_array()
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = build.ptr
    rc = lib.fq_scan_launch(
        p(fm.kernel_table()), hp.ctypes.data_as(ctypes.c_void_p),
        sp.ctypes.data_as(ctypes.c_void_p), p(seqs8), p(lens32), p(md32),
        p(us32), p(nn32), N, p(widths), p(seed32), p(pool), p(freel),
        p(alns), p(n_aln), p(fb), p(steps), B, int(inner), _n_ids(md),
        p(sync), p(stats), ctypes.c_void_p(stream))
    build.check(rc, "scan")
    build.launch_counts["scan"] += 1
    return n_aln, alns, fb, steps, int(stats[0]), stats[1]
