"""Data-parallel QC over ranks: process groups, collectives and the
sharded steps.

Counterpart of fastquick_tpu/parallel/mesh.py over torch.distributed.  The
scaling model is the reference's: FASTQ rows shard data-parallel over the
ranks, the reduced-reference index and the site tables are replicated on
every rank (a few MB), and every statistic is merged with a sum -- all
StatCollector accumulators are vectors, histograms and counters
(reference src/StatCollector.h:70-119).

Where the reference traces one program over a jax Mesh under shard_map,
the port runs one process a rank: each rank calls the step on its own
rows, and the collectives inside and around the step go through the
rank's process groups.  ``Mesh`` names those groups as the reference
names its mesh axes:

- make_mesh(): one axis 'dp' over the default group;
- make_mesh_2d(h, c): axes ('host', 'chip') with rank = host * c + chip;
  the 'chip' groups hold contiguous ranks, the 'host' groups stride
  across them, and reductions run at the chip level first, as the
  reference's ``for ax in reversed(axes)``.

The backend is the caller's (init_process_group): nccl where every rank
has a card of its own, gloo otherwise (ranks that share one card, or the
CPU).  gloo's collectives take no CUDA tensors, so on a gloo group the
helpers copy to the host and back, explicitly; the compute stays on the
rank's device.  Nothing swaps the backend, and a failed collective
raises.

``spawn`` starts n ranks as fresh processes over a FileStore in a
temporary directory and returns what each rank's function returned; a
rank that fails makes it raise.
"""

from __future__ import annotations

import math
import os
import pickle
import tempfile
from datetime import timedelta

import torch
import torch.distributed as dist

from ..ops.fm import DeviceFM, match_exact, sa_lookup
from ..ops.kmer import filter_reads
from ..ops.pileup import depth_pileup
from ..ops.qc_full import (
    PILEUP_CAP,
    SiteTables,
    _Stages,
    count_pcr_dups,
    qc_step_full,
    ragged_unreverse,
)


class Mesh:
    """Named axes of process groups over the default group's ranks: each
    axis's size, this rank's index on it and its group."""

    def __init__(self, axis_names, sizes, groups, coords):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, sizes))
        self._groups = dict(zip(self.axis_names, groups))
        self._coords = dict(zip(self.axis_names, coords))
        self._host_copy = {ax: dist.get_backend(g) == "gloo"
                           for ax, g in self._groups.items()}

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_size(self, ax: str) -> int:
        return self.shape[ax]

    def axis_index(self, ax: str) -> int:
        return self._coords[ax]

    def shard_index(self, axes=None) -> int:
        """This rank's block among the shards of `axes` (outer axis first;
        every axis by default): the reference's rank * size + index."""
        r = 0
        for ax in (self.axis_names if axes is None else axes):
            r = r * self.shape[ax] + self._coords[ax]
        return r

    def _wire(self, x: torch.Tensor, ax: str) -> torch.Tensor:
        """A fresh contiguous copy to hand the collective: on the host for
        a gloo group; bool as uint8."""
        t = x.to("cpu", copy=True) if self._host_copy[ax] else x.clone()
        return (t.to(torch.uint8) if t.dtype == torch.bool
                else t).contiguous()

    def all_gather(self, x: torch.Tensor, ax: str) -> torch.Tensor:
        """(axis_size(ax), *x.shape): every member's x in axis order."""
        t = self._wire(x, ax)
        out = torch.empty((self.shape[ax],) + tuple(t.shape), dtype=t.dtype,
                          device=t.device)
        dist.all_gather(list(out.unbind(0)), t, group=self._groups[ax])
        return out.to(device=x.device, dtype=x.dtype)

    def _reduce(self, x: torch.Tensor, ax: str, op) -> torch.Tensor:
        t = self._wire(x, ax)
        dist.all_reduce(t, op=op, group=self._groups[ax])
        return t.to(device=x.device, dtype=x.dtype)

    def psum(self, x: torch.Tensor, ax: str) -> torch.Tensor:
        return self._reduce(x, ax, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor, ax: str) -> torch.Tensor:
        return self._reduce(x, ax, dist.ReduceOp.MAX)


def make_mesh(n: int | None = None, axis: str = "dp") -> Mesh:
    """One axis over the default group (n, when given, must be its
    size)."""
    world = dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(f"a mesh of {n} ranks over a group of {world}")
    return Mesh((axis,), (world,), (dist.group.WORLD,), (dist.get_rank(),))


def make_mesh_2d(n_hosts: int, chips_per_host: int) -> Mesh:
    """Axes ('host', 'chip') over the default group's n_hosts *
    chips_per_host ranks, rank = host * chips_per_host + chip.  Every rank
    makes every subgroup, in one order (dist.new_group's rule)."""
    world = dist.get_world_size()
    if n_hosts * chips_per_host != world:
        raise ValueError(f"a {n_hosts} x {chips_per_host} mesh over a group "
                         f"of {world}")
    h, c = divmod(dist.get_rank(), chips_per_host)
    chip_group = host_group = None
    for hh in range(n_hosts):
        g = dist.new_group(list(range(hh * chips_per_host,
                                      (hh + 1) * chips_per_host)))
        if hh == h:
            chip_group = g
    for cc in range(chips_per_host):
        g = dist.new_group(list(range(cc, world, chips_per_host)))
        if cc == c:
            host_group = g
    return Mesh(("host", "chip"), (n_hosts, chips_per_host),
                (host_group, chip_group), (h, c))


def _axes(axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _gather(mesh: Mesh, x: torch.Tensor, axes: tuple) -> torch.Tensor:
    """(shards, *x.shape) in global shard order: gathered innermost axis
    first, so the outer axis is the slowest."""
    for ax in reversed(axes):
        x = mesh.all_gather(x, ax)
    return x.reshape((-1,) + tuple(x.shape[len(axes):]))


def _psum_all(mesh: Mesh, stats: dict, axes: tuple) -> dict:
    for ax in reversed(axes):  # the chip level first, the host level last
        stats = {k: mesh.psum(v, ax) for k, v in stats.items()}
    return stats


def qc_step_local(fm: DeviceFM, n_text: int, bitmaps, thresh: int,
                  seqs, rseqs, lens, quals) -> dict:
    """One shard's exact-match QC step: k-mer filter, exact backward
    search of both strands, SA positions, depth pileup.  seqs / rseqs:
    (B, L) reversed / revcomp codes; lens: (B,); quals: (B, L) phred.
    Returns stat accumulators (commutative sums)."""
    B, L = seqs.shape
    dev = seqs.device
    lens = lens.long()
    fwd = ragged_unreverse(seqs, lens)
    kept = filter_reads(bitmaps, fwd, lens, thresh) if bitmaps is not None \
        else torch.ones(B, dtype=torch.bool, device=dev)
    # strand a searches index 1 - a (bwt_match_gap, libbwa/bwtgap.c:148)
    k0, l0 = match_exact(fm, 1, seqs, lens)
    k1, l1 = match_exact(fm, 0, rseqs, lens)
    hit0 = kept & (k0 <= l0)
    hit1 = kept & (k1 <= l1) & ~hit0
    # bwa_cal_pac_pos (src/BwtMapper.cpp:294-328)
    pos0 = n_text - (sa_lookup(fm, torch.ones(B, dtype=torch.long,
                                              device=dev),
                               torch.where(hit0, k0, 0)).long() + lens)
    pos1 = sa_lookup(fm, torch.zeros(B, dtype=torch.long, device=dev),
                     torch.where(hit1, k1, 0)).long()
    mapped = hit0 | hit1
    stats = depth_pileup(torch.where(hit0, pos0, pos1), lens, mapped, quals,
                         n_text)
    stats["n_mapped"] = mapped.sum().to(torch.int32)
    stats["n_reads"] = torch.tensor(B, dtype=torch.int32, device=dev)
    stats["n_filtered"] = (~kept).sum().to(torch.int32)
    return stats


def make_sharded_qc_step(mesh: Mesh, fm: DeviceFM, n_text: int,
                         bitmaps=None, thresh: int = 3, axis="dp"):
    """The exact-match step over the mesh: run(seqs, rseqs, lens, quals)
    on this rank's rows returns the stats summed over `axis` (a name or a
    tuple like ('host', 'chip'), reduced innermost first)."""
    axes = _axes(axis)

    def run(seqs, rseqs, lens, quals):
        return _psum_all(mesh, qc_step_local(fm, n_text, bitmaps, thresh,
                                             seqs, rseqs, lens, quals), axes)

    return run


def make_sharded_qc_full_step(mesh: Mesh, fm: DeviceFM, tables: SiteTables,
                              opt_args: dict, bitmaps=None, thresh: int = 3,
                              pileup_cap: int = PILEUP_CAP, axis="dp",
                              md_table=None, pair_mode: bool = False,
                              kernel: str = "resident"):
    """The product step over the mesh: run(seqs, rseqs, quals, lens,
    last_ii=None, fb_fill=None, times=None, return_per_read=False,
    counts=None) takes
    this rank's rows (every rank the same count; the shards in rank order
    are the batch), the index and site tables replicated, and returns the
    merged accumulators, equal on every rank and to one device's step on
    the whole batch (n_reads counts padding rows).

    Inside the step (ops/qc_full.qc_step_full under axis_names): the
    drand48 draw over the gathered hit lists, the summed insert-size
    histogram and the second pairing pass's budget in global read order.
    Around it: the marker pileups keep global read order (each rank
    gathers the per-marker entry counts and shifts its entries to its
    global slots, so the sum of the disjoint slots is the ordered
    concatenation), the pair keys are gathered for count_pcr_dups (after
    the sum, not summed) and each per-pair row field is gathered in rank
    order; _ii, the histogram, its max length and _drand_state are the
    same on every rank and pass the sum untouched.  Every other
    accumulator is summed.  fb_fill: this rank's rows' fill; times gains
    an "exchange" stage (the collectives and the merge); per_read and
    counts (qc_step_full's) stay this rank's."""
    axes = _axes(axis)
    inner_first = tuple(reversed(axes))

    def run(seqs, rseqs, quals, lens, last_ii=None, fb_fill=None,
            times=None, return_per_read=False, counts=None):
        out = qc_step_full(fm, tables, opt_args, seqs, rseqs, quals, lens,
                           bitmaps=bitmaps, thresh=thresh,
                           pileup_cap=pileup_cap, md_table=md_table,
                           pair_mode=pair_mode, last_ii=last_ii,
                           fb_fill=fb_fill, kernel=kernel, times=times,
                           counts=counts, return_per_read=return_per_read,
                           mesh=mesh, axis_names=inner_first)
        out, per_read = out if return_per_read else (out, None)
        with _Stages(times, seqs.device)("exchange"):
            carried = {k: out.pop(k) for k in ("_drand_state", "_ii",
                                               "_isize_hist", "_isize_maxlen")
                       if k in out}
            if pair_mode:
                gkeys = _gather(mesh, out.pop("_pair_keys"), axes)
                rows = {k: _gather(mesh, v, axes).reshape(-1)
                        for k, v in out.pop("_pair_rows").items()}
            M = tables.n_markers
            dev = out["pileup"].device
            cnt = out["pileup_cnt"]
            g = _gather(mesh, cnt, axes)  # (shards, M)
            off = g[: mesh.shard_index(axes)].sum(0).long()  # my global base
            cold = torch.arange(pileup_cap, device=dev)[None, :]
            tgt = cold + off[:, None]
            valid = cold < cnt.long()[:, None]
            keep = valid & (tgt < pileup_cap)
            prow = torch.arange(M, device=dev)[:, None].expand(M, pileup_cap)
            shifted = torch.zeros((M, pileup_cap), dtype=out["pileup"].dtype,
                                  device=dev)
            shifted.index_put_((prow[keep], tgt[keep]), out["pileup"][keep],
                               accumulate=True)
            out["pileup"] = shifted
            out["pileup_ovf"] = out["pileup_ovf"] + (
                valid & (tgt >= pileup_cap)).sum().to(out["pileup_ovf"].dtype)
            out = _psum_all(mesh, out, axes)
            if pair_mode:
                out["n_pcr_dup"] = count_pcr_dups(gkeys.reshape(-1, 3))
                out["_pair_rows"] = rows
            out.update(carried)
        return (out, per_read) if return_per_read else out

    return run


def local_rows(mesh: Mesh, n_rows: int, axes=None) -> tuple[int, int]:
    """(start, rows) of this rank's block when n_rows rows (a multiple of
    the shards) split over `axes` (every axis by default) in rank order."""
    axes = mesh.axis_names if axes is None else _axes(axes)
    n = math.prod(mesh.shape[ax] for ax in axes)
    if n_rows % n:
        raise ValueError(f"{n_rows} rows over {n} shards")
    per = n_rows // n
    return mesh.shard_index(axes) * per, per


# ---------------------------------------------------------------- ranks


def _rank_main(rank: int, n: int, hosts, backend: str, tmp: str, fn,
               args: tuple, timeout_s: float) -> None:
    torch.set_num_threads(1)  # n ranks share the host's cores
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.FileStore(os.path.join(tmp, "store"), n)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                            timeout=timedelta(seconds=timeout_s))
    try:
        mesh = make_mesh() if hosts is None else make_mesh_2d(hosts,
                                                              n // hosts)
        result = fn(mesh, *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(result, fh)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn, n: int, args: tuple = (), hosts: int | None = None,
          backend: str = "gloo", timeout_s: float = 1800.0) -> list:
    """Run fn(mesh, *args) in n new processes, one rank each, and return
    the n results in rank order.  fn is a module-level function (it is
    sent by import path) and returns picklable values (numpy, not CUDA
    tensors).  hosts: None for make_mesh(), else make_mesh_2d(hosts,
    n // hosts).  Each rank runs torch on one intra-op thread.  A rank
    that raises or dies makes this raise, after the others are stopped."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="fq_mesh_") as tmp:
        mp.start_processes(_rank_main, args=(n, hosts, backend, tmp, fn,
                                             tuple(args), timeout_s),
                           nprocs=n, join=True, start_method="spawn")
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))
    return out
