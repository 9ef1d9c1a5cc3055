"""Per-base accumulation: the dense statistics and the marker pileups of a
batch of placed reads.

The accumulation stage of the one-program step (fastquick_tpu/ops/
qc_full.py:623-690, inside qc_step_full) and the dense program of ``align
--device_qc`` (fastquick_tpu/align/device_qc.py:69-98) compute the same
per-base arithmetic: each covered base of an eligible read, at its pac
position, lies on a dense site or not; on one, it adds to its site's
depth and Q20/Q30 tier, to the empirical quality and cycle histograms
and, where it differs from a non-dbSNP reference base, to their mismatch
twins.  The one-program step also writes each base on a marker into that
marker's pileup slots in read order.

Two kernels (csrc/accumulate.cu): the walk (fq_accum_walk, counted in
``launch_counts["accumulate"]``) visits the (B, L) grid once a read at a
time and adds the dense sums, lists the pileup entries, or both; the
order (fq_accum_order, counted in ``launch_counts["pileup"]``) puts the
listed entries in read order into their markers' slots without touching
the grid.  Wrappers, each with its plain PyTorch version beside it (the
port's torch code before the kernels, moved here unchanged; CPU tensors
run it):

- ``accumulate_pileup`` (qc_step_full: int32 planes in read orientation,
  the eligible rows): one walk for both, then the order; plain:
  ``accumulate_plain`` and ``pileup_plain``.
- ``accumulate``: the walk's dense sums alone; plain: ``accumulate_plain``.
- ``dense_accumulate`` (DeviceDenseStats: uint8 planes in reference
  orientation, every row): the walk's dense sums, into a fresh output or
  added to the caller's resident one; plain: ``dense_accumulate_plain``.
- ``pileup``: the walk's entries alone (the marker word read first), then
  the order; plain: ``pileup_plain`` (its ranks from ``_pileup_ranks``, a
  stable sort).

The dense sums are one int32 vector laid out as DENSE_FIELDS
(``unpack_dense`` cuts it), so that a caller on the host copies it once.
A CUDA tensor launches its kernels or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..kernels import build

_i32 = torch.int32
_i64 = torch.long

MODE_READ, MODE_REF = 0, 1  # csrc/accumulate_body.cuh FQ_ACC_READ / _REF

# the dense output's fields in order: (name, length with S sites)
DENSE_FIELDS = (("depth", "S"), ("q20", "S"), ("q30", "S"),
                ("emp_rep", 256), ("mis_emp_rep", 256), ("emp_cycle", 256),
                ("mis_emp_cycle", 256), ("n_base_mapped", 1))


def dense_size(S: int) -> int:
    """The dense output's length with S sites."""
    return 3 * S + 4 * 256 + 1


def unpack_dense(out, S: int) -> dict:
    """The dense output's fields as views (tensors or numpy arrays):
    depth, q20, q30 (S,), the four histograms (256,), n_base_mapped 0-d."""
    res, at = {}, 0
    for name, n in DENSE_FIELDS:
        n = S if n == "S" else n
        res[name] = out[at] if name == "n_base_mapped" else out[at: at + n]
        at += n
    return res


# packed pileup entry: present(1) | base(3) | qual(7) | mapq(7) |
# strand(1) | cycle(10)  (cycle < 1024)
def _pack_entry(base, qual, mapq, strand, cycle):
    return (1 | (base << 1) | (qual << 4) | (mapq << 11)
            | (strand << 18) | (cycle << 19))


def ragged_unreverse(arr: torch.Tensor, lens: torch.Tensor,
                     fill: int = 4) -> torch.Tensor:
    """Row-wise arr[b, lens[b]-1-j] (undo bwa's stored reversal with
    per-row lengths)."""
    B, L = arr.shape
    idx = lens.long()[:, None] - 1 - torch.arange(L, device=arr.device)[None]
    out = arr.gather(1, idx.clamp(0, L - 1))
    return torch.where(idx >= 0, out, fill)


def _pileup_ranks(mk_flat: torch.Tensor, valid: torch.Tensor):
    """Arrival rank of each candidate within its marker, in flattened
    (read-major) order == global read order within the batch."""
    K = mk_flat.shape[0]
    dev = mk_flat.device
    keys = torch.where(valid, mk_flat.long(), 0x3FFFFFFF)
    sk, order = torch.sort(keys, stable=True)
    is_start = torch.ones(K, dtype=torch.bool, device=dev)
    is_start[1:] = sk[1:] != sk[:-1]
    iota = torch.arange(K, device=dev)
    start_pos = torch.cummax(torch.where(is_start, iota, 0), 0).values
    ranks = torch.empty(K, dtype=_i32, device=dev)
    ranks[order] = (iota - start_pos).to(_i32)
    return ranks


# ---------------------------------------------------------------- plain


def _plain_bases(tables, n_text, seqs, rseqs, quals, lens, eligible, pos,
                 strand):
    """The covered (B, L) grid of the one-program step: each base's pac
    position, region flag, site, read base, quality and cycle in reference
    orientation.  (B, L) planes stay int32; only the flat scatter indices
    are int64."""
    B, L = seqs.shape
    dev = seqs.device
    offs = torch.arange(L, dtype=_i32, device=dev)[None, :]
    lens32 = lens.to(_i32)[:, None]
    cover = eligible[:, None] & (offs < lens32)
    pacp = torch.where(cover, pos[:, None] + offs, n_text).clamp(0, n_text)
    # read bases / quals / cycles in reference orientation: a strand-1
    # read's reverse complement is rseqs as stored, its qualities reversed
    rev = (strand == 1)[:, None]
    ref_read = torch.where(rev, rseqs, ragged_unreverse(seqs, lens)).to(_i32)
    ref_qual = torch.where(rev, ragged_unreverse(quals, lens, fill=0), quals)
    cycle = torch.where(rev, (lens32 - 1 - offs).clamp(0, L), offs)
    site = tables.site_idx[pacp]  # (B, L) int32
    in_reg = cover & (site >= 0)
    bq = ref_qual.clamp(0, 93).to(_i32)
    return pacp, in_reg, site, ref_read, bq, cycle


def accumulate_plain(tables, n_text, seqs, rseqs, quals, lens, eligible,
                     pos, strand) -> dict:
    """The plain version of ``accumulate``."""
    dev = seqs.device
    S = tables.n_sites
    pacp, in_reg, site, ref_read, bq, cycle = _plain_bases(
        tables, n_text, seqs, rseqs, quals, lens, eligible, pos, strand)
    fb_base = tables.text[pacp]
    del pacp
    site_c = torch.where(in_reg, site.long(), S)
    del site
    dbsnp_g = torch.cat([tables.dbsnp,
                         torch.zeros(1, dtype=torch.bool, device=dev)])
    mism = (in_reg & (ref_read < 4) & (fb_base < 4) & (ref_read != fb_base)
            & ~dbsnp_g[site_c])
    del fb_base

    ones = in_reg.reshape(-1).long()
    tier = ((bq >= 20).long() + (bq >= 30).long()).reshape(-1)
    dense3 = torch.zeros(3 * (S + 1), dtype=_i64, device=dev)
    dense3.index_add_(0, site_c.reshape(-1) + tier * (S + 1), ones)
    del tier, site_c
    t0, t1, t2 = (dense3[: S], dense3[S + 1: 2 * S + 1],
                  dense3[2 * S + 2:][: S])
    bq_flat = torch.where(in_reg, bq, 255).reshape(-1).long()
    cyc_flat = torch.where(in_reg, cycle, 255).reshape(-1).clamp(
        0, 255).long()
    mism_ones = mism.reshape(-1).long()
    del mism

    def hist(idx, val):
        return torch.zeros(256, dtype=_i64, device=dev).index_add_(
            0, idx, val).to(_i32)

    return {"depth": (t0 + t1 + t2).to(_i32), "q20": (t1 + t2).to(_i32),
            "q30": t2.to(_i32), "emp_rep": hist(bq_flat, ones),
            "mis_emp_rep": hist(bq_flat, mism_ones),
            "emp_cycle": hist(cyc_flat, ones),
            "mis_emp_cycle": hist(cyc_flat, mism_ones),
            "n_base_mapped": in_reg.sum().to(_i32)}


def pileup_plain(tables, n_text, seqs, rseqs, quals, lens, eligible, pos,
                 strand, mapq, pileup_cap: int,
                 marker_base: torch.Tensor | None) -> dict:
    """The plain version of ``pileup``: the entries on a marker, in
    flattened (read-major) order."""
    dev = seqs.device
    L = seqs.shape[1]
    M = tables.n_markers
    pacp, in_reg, _, ref_read, bq, cycle = _plain_bases(
        tables, n_text, seqs, rseqs, quals, lens, eligible, pos, strand)
    mk = tables.marker_id[pacp]
    on_mk = (in_reg & (mk >= 0)).reshape(-1)
    idx = on_mk.nonzero()[:, 0]
    mk_v = mk.reshape(-1)[idx].long()
    ranks = _pileup_ranks(mk_v, torch.ones_like(mk_v, dtype=torch.bool))
    b_of = idx // L
    packed = _pack_entry(
        ref_read.reshape(-1)[idx].clamp(0, 4).long(),
        bq.reshape(-1)[idx].long(), mapq[b_of].clamp(0, 127),
        (strand[b_of] == 1).long(),
        cycle.reshape(-1)[idx].clamp(0, 1023).long())
    base_off = (torch.zeros(M, dtype=_i64, device=dev) if marker_base is None
                else marker_base.long())
    slot = ranks.long() + base_off[mk_v]
    ok = slot < pileup_cap
    pile = torch.zeros((M + 1) * pileup_cap, dtype=_i64, device=dev)
    pile.index_add_(0, torch.where(ok, mk_v * pileup_cap + slot,
                                   M * pileup_cap), torch.where(ok, packed,
                                                                0))
    return {"pileup": pile[: M * pileup_cap].reshape(M, pileup_cap).to(_i32),
            "pileup_cnt": torch.zeros(M, dtype=_i64, device=dev).index_add_(
                0, mk_v, torch.ones_like(mk_v)).to(_i32),
            "pileup_ovf": (~ok).sum().to(_i32)}


def dense_accumulate_plain(tab, n_text: int, pos: torch.Tensor,
                           strand: torch.Tensor, codes: torch.Tensor,
                           quals: torch.Tensor, lens: torch.Tensor):
    """The plain version of ``dense_accumulate``: one accumulation program
    over a (B, L) batch of reference-oriented codes/quals.  Returns int64
    (dense3 (3*(S+1),), emp_rep, emp_cyc, mis_rep, mis_cyc (256,) each)."""
    S = tab.n_sites
    dev = codes.device
    B, L = codes.shape
    offs = torch.arange(L, dtype=torch.long, device=dev)[None, :]
    lens = lens.long()
    cover = offs < lens[:, None]
    pacp = torch.where(cover, pos.long()[:, None] + offs, n_text)
    pacp = pacp.clamp(0, n_text)
    site = tab.site_idx[pacp].long()
    in_reg = cover & (site >= 0)
    site_c = torch.where(in_reg, site, S)
    fb = tab.text[pacp].long()
    codes = codes.long()
    bq = quals.long().clamp(0, 255)
    mism = in_reg & (codes < 4) & (fb < 4) & (codes != fb)
    dbsnp_g = torch.cat([tab.dbsnp, torch.zeros(1, dtype=torch.bool,
                                                device=dev)])
    mism = mism & ~dbsnp_g[site_c.clamp(0, S)]
    cycle = torch.where((strand == 1)[:, None], lens[:, None] - 1 - offs,
                        offs)
    ones = in_reg.long().reshape(-1)
    tier = ((bq >= 20).long() + (bq >= 30).long()).reshape(-1)
    dense3 = torch.zeros(3 * (S + 1), dtype=torch.long, device=dev)
    dense3.index_add_(0, site_c.reshape(-1) + tier * (S + 1), ones)
    bq_f = torch.where(in_reg, bq, 255).reshape(-1)
    cy_f = torch.where(in_reg, cycle.clamp(0, 255), 255).reshape(-1)
    m_ones = mism.long().reshape(-1)

    def hist(idx, val):
        return torch.zeros(256, dtype=torch.long, device=dev).index_add_(
            0, idx, val)

    return (dense3, hist(bq_f, ones), hist(cy_f, ones), hist(bq_f, m_ones),
            hist(cy_f, m_ones))


def pack_dense_plain(plain: tuple, S: int) -> torch.Tensor:
    """dense_accumulate_plain's five int64 outputs in the dense layout
    (DENSE_FIELDS) as the kernel writes it: the tiers summed as
    DeviceDenseStats sums them, n_base_mapped as the quality histogram's
    total, int32 (the int64 sums mod 2^32)."""
    dense3, emp_rep, emp_cyc, mis_rep, mis_cyc = plain
    c0, c1, c2 = (dense3[:S], dense3[S + 1:2 * S + 1],
                  dense3[2 * S + 2:][:S])
    return torch.cat([c0 + c1 + c2, c1 + c2, c2, emp_rep, mis_rep, emp_cyc,
                      mis_cyc, emp_rep.sum().reshape(1)]).to(_i32)


# --------------------------------------------------------------- kernels


class AccCall(NamedTuple):
    """A kernel's C arguments (before its outputs), the tensors they point
    at (alive until the call returns) and its batch shape."""
    args: list
    keep: list
    B: int
    L: int


def acc_call(tables, n_text: int, mode: int, seqs, rseqs, quals, lens,
             pos, strand, eligible=None, mapq=None) -> AccCall:
    """The accumulation kernels' inputs as their C interface takes them
    (csrc/accumulate_body.cuh FQ_ACC_IN_ARGS): the planes (int32 in
    MODE_READ, uint8 in MODE_REF), the per-read fields int64, eligible as
    bytes, the tables; a copy only of what is not so already."""
    B, L = seqs.shape
    if B * L >= 2 ** 31 or L > 2 ** 29:
        raise ValueError(f"batch of {B} x {L} bases: at most 2^31 - 1")
    if n_text + L + 2 >= 2 ** 31:  # the kernels' 32-bit pac positions
        raise ValueError(f"text of {n_text} bases: at most 2^31 - L - 3")
    pt = _i32 if mode == MODE_READ else torch.uint8

    def c(t, dtype):
        return None if t is None else t.to(dtype).contiguous()

    planes = [c(seqs, pt), c(rseqs, pt), c(quals, pt)]
    for t in (planes[0], planes[2]) + ((planes[1],) if mode == MODE_READ
                                       else ()):
        if t.shape != (B, L):
            raise ValueError(f"planes must be ({B}, {L}), got "
                             f"{tuple(t.shape)}")
    reads = [c(t, _i64) for t in (pos, strand, lens)]
    elig = c(eligible, torch.bool)
    mq = c(mapq, _i64)
    for t in reads + [elig, mq]:
        if t is not None and t.shape != (B,):
            raise ValueError(f"per-read fields must be ({B},), got "
                             f"{tuple(t.shape)}")
    tabs = [c(tables.site_idx, _i32), c(tables.marker_id, _i32),
            c(tables.text, _i32), c(tables.dbsnp, torch.bool)]
    if min(t.numel() for t in tabs[:3]) <= n_text or \
            tabs[3].numel() != tables.n_sites:
        raise ValueError(f"site tables must hold n_text + 1 = {n_text + 1} "
                         f"positions and {tables.n_sites} dbSNP flags")
    keep = [t for t in planes + reads + [elig, mq] + tabs if t is not None]
    args = [*(_p(t) for t in planes), *(_p(t) for t in reads), _p(elig),
            _p(mq), *(_p(t) for t in tabs), int(n_text), B, L,
            int(tables.n_sites), mode]
    return AccCall(args, keep, B, L)


def _p(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


class Walk(NamedTuple):
    """A walk's arguments after its inputs (out, zero_out, ent, counts, M)
    and the tensors it writes: the dense sums or None; the entry list (B
    L,) and counts (M + 2,: each marker's entries, the entries listed, the
    pileup's overflow) or None."""
    tail: list
    out: torch.Tensor | None
    ent: torch.Tensor | None
    counts: torch.Tensor | None


def walk_call(call: AccCall, tables, dense: bool = True, out=None,
              entries: bool = False) -> Walk:
    """The walk kernel's arguments after call's: the dense sums (dense:
    into out when given, int32 dense_size(S) contiguous, added to; else
    into a new output that the launch zeroes) and the pileup entries
    (entries), its outputs allocated here and kept alive in call.keep."""
    S = int(tables.n_sites)
    dev = call.keep[0].device
    if dense and out is None:
        zero, out = True, torch.empty(dense_size(S), dtype=_i32, device=dev)
    else:
        zero = False
    if out is not None and (out.dtype != _i32 or out.shape != (dense_size(S),)
                            or not out.is_contiguous()):
        raise ValueError(f"dense sums must be contiguous int32 "
                         f"({dense_size(S)},)")
    M = int(tables.n_markers) if entries else 0
    ent = counts = None
    if entries:
        ent = torch.empty(call.B * call.L, dtype=_i32, device=dev)
        counts = torch.empty(M + 2, dtype=_i32, device=dev)
    call.keep.extend(t for t in (out, ent, counts) if t is not None)
    return Walk([_p(out), int(zero), _p(ent), _p(counts), M], out, ent,
                counts)


def order_call(call: AccCall, tables, walk: Walk, pileup_cap: int,
               marker_base):
    """(tail, pileup outputs): the order kernels' arguments after call's
    (marker_base, M, cap, ent, counts, pileup, off, bucket) and the
    pileup dict (pileup (M, pileup_cap), pileup_cnt (M,), pileup_ovf
    0-d, int32; the last two views of the walk's counts)."""
    M = int(tables.n_markers)
    dev = walk.ent.device
    mb = None if marker_base is None else marker_base.to(_i32).contiguous()
    if mb is not None and mb.shape != (M,):
        raise ValueError(f"marker_base must be ({M},)")
    pile = torch.empty((M, pileup_cap), dtype=_i32, device=dev)
    off = torch.empty(M + 1, dtype=_i32, device=dev)
    bucket = torch.empty(call.B * call.L, dtype=_i32, device=dev)
    call.keep.extend(t for t in (mb, pile, off, bucket) if t is not None)
    tail = [_p(mb), M, int(pileup_cap), _p(walk.ent), _p(walk.counts),
            _p(pile), _p(off), _p(bucket)]
    return tail, {"pileup": pile, "pileup_cnt": walk.counts[:M],
                  "pileup_ovf": walk.counts[M + 1]}


def _stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _walk(call: AccCall, walk: Walk) -> None:
    build.require_cuda(*call.keep)
    rc = build.cuda_library().fq_accum_walk_launch(
        *call.args, *walk.tail, _stream(call.keep[0].device))
    build.check(rc, "accumulate")
    build.launch_counts["accumulate"] += 1


def _order(call: AccCall, tail: list) -> None:
    build.require_cuda(*call.keep)
    rc = build.cuda_library().fq_accum_order_launch(
        *call.args, *tail, _stream(call.keep[0].device))
    build.check(rc, "pileup")
    build.launch_counts["pileup"] += 1


def step_outputs(dense: dict, pile: dict) -> dict:
    """The one-program step's accumulators in its order: the dense sums,
    the pileups, n_base_mapped."""
    out = {k: v for k, v in dense.items() if k != "n_base_mapped"}
    out.update(pile)
    out["n_base_mapped"] = dense["n_base_mapped"]
    return out


def accumulate_pileup(tables, n_text, seqs, rseqs, quals, lens, eligible,
                      pos, strand, mapq, pileup_cap: int,
                      marker_base=None) -> dict:
    """The one-program step's per-base accumulators in one walk of the
    grid: ``accumulate``'s dense sums and ``pileup``'s marker pileups
    (its arguments), n_base_mapped last.  CUDA tensors launch the walk
    (sums and entry list) and the order, CPU tensors run accumulate_plain
    and pileup_plain."""
    args = (tables, n_text, seqs, rseqs, quals, lens, eligible, pos, strand)
    if seqs.device.type == "cpu":
        return step_outputs(accumulate_plain(*args), pileup_plain(
            *args, mapq, pileup_cap, marker_base))
    call = acc_call(tables, n_text, MODE_READ, seqs, rseqs, quals, lens,
                    pos, strand, eligible, mapq)
    walk = walk_call(call, tables, entries=True)
    tail, pile = order_call(call, tables, walk, pileup_cap, marker_base)
    _walk(call, walk)
    _order(call, tail)
    return step_outputs(unpack_dense(walk.out, int(tables.n_sites)), pile)


def accumulate(tables, n_text, seqs, rseqs, quals, lens, eligible, pos,
               strand) -> dict:
    """The one-program step's dense statistics over the covered (B, L)
    grid: depth, q20, q30 (S,), emp_rep, mis_emp_rep, emp_cycle,
    mis_emp_cycle (256,) and n_base_mapped (0-d), int32.

    seqs, rseqs: (B, L) the reversed codes and the reverse complement as
    bwa stores them; quals: (B, L) phred in read order; lens, pos,
    strand: (B,); eligible: (B,) bool.  CUDA tensors launch the walk
    (views of its one output), CPU tensors run accumulate_plain."""
    if seqs.device.type == "cpu":
        return accumulate_plain(tables, n_text, seqs, rseqs, quals, lens,
                                eligible, pos, strand)
    call = acc_call(tables, n_text, MODE_READ, seqs, rseqs, quals, lens,
                    pos, strand, eligible)
    walk = walk_call(call, tables)
    _walk(call, walk)
    return unpack_dense(walk.out, int(tables.n_sites))


def dense_accumulate(tab, n_text: int, pos: torch.Tensor,
                     strand: torch.Tensor, codes: torch.Tensor,
                     quals: torch.Tensor, lens: torch.Tensor,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """DeviceDenseStats' accumulation over a (B, L) batch of reference-
    oriented uint8 codes/quals (every row): the dense layout
    (DENSE_FIELDS) as one int32 vector, sums mod 2^32, in a new vector or
    added to out (contiguous int32, on the inputs' device) and returned.
    CUDA tensors launch the walk, CPU tensors run dense_accumulate_plain
    (pack_dense_plain)."""
    if codes.device.type == "cpu":
        sums = pack_dense_plain(dense_accumulate_plain(
            tab, n_text, pos, strand, codes, quals, lens), tab.n_sites)
        return sums if out is None else out.add_(sums)
    call = acc_call(tab, n_text, MODE_REF, codes, None, quals, lens, pos,
                    strand)
    walk = walk_call(call, tab, out=out)
    _walk(call, walk)
    return walk.out


def pileup(tables, n_text, seqs, rseqs, quals, lens, eligible, pos, strand,
           mapq, pileup_cap: int, marker_base=None) -> dict:
    """The marker pileups of the one-program step: pileup (M, pileup_cap)
    packed entries (_pack_entry) in read order from slot marker_base[m]
    (0 when None; >= 0), pileup_cnt (M,) entries a marker, pileup_ovf
    (0-d) entries past the cap; int32.  The inputs as ``accumulate``'s,
    with mapq (B,).  CUDA tensors launch the walk (its entries alone) and
    the order, CPU tensors run pileup_plain."""
    if seqs.device.type == "cpu":
        return pileup_plain(tables, n_text, seqs, rseqs, quals, lens,
                            eligible, pos, strand, mapq, pileup_cap,
                            marker_base)
    call = acc_call(tables, n_text, MODE_READ, seqs, rseqs, quals, lens,
                    pos, strand, eligible, mapq)
    walk = walk_call(call, tables, dense=False, entries=True)
    tail, pile = order_call(call, tables, walk, pileup_cap, marker_base)
    _walk(call, walk)
    _order(call, tail)
    return pile
