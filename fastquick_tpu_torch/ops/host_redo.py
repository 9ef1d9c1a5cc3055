"""The one-program step's exact redo of its first pass's fallback rows, and
the fill that carries their hit lists into the second pass
(``qc_step_full(fb_fill=...)``; qc_program.run_with_fill).

The route follows the engine it is given:

- a ``NativeEngine`` gets the rows as arrays: their ``(n, 2, L)`` planes
  taken from the world's host planes (``host_rows``, built once a world),
  their max-diff by length, one ``aln_batch`` call through the engine's
  handle into a buffer kept with the world, and the fill packed from its
  output arrays.  Rows whose hit list overflows the engine's ``OUT_CAP``
  go on to the engine's Python oracle, as ``NativeEngine.align_batch``
  sends them;
- any other engine (``HostEngine``) aligns copies of the rows' ``Read``
  objects and ``pack_host_hits`` packs their hit lists.

Both give the same fill, bit for bit, as the engine's own ``align_batch``
followed by ``pack_host_hits``.  Only the rows with a fill cross to the
device; the dense ``(nb, A_MAX, 3)`` plane is scattered there.
"""

from __future__ import annotations

import copy
import ctypes

import numpy as np
import torch

from ..align.engine import NativeEngine
from ..align.opts import bwa_cal_maxdiff
from ..align.sample_setup import exact_engine
from ..utils import spans
from .qc_full import pack_host_hits
from .search_kernels import A_MAX


def host_rows(world) -> dict:
    """The world's reads as host arrays, in row order: ``planes`` (B, 2, L)
    uint8 (seq, rseq; N past a read's length and on filtered rows),
    ``lens`` (B,) int32 and ``filtered`` (B,) bool.  Cached in the world
    beside the list of reads they were built from, and built again when
    ``world["reads"]`` is another list."""
    reads = world["reads"]
    hr = world.get("host_rows")
    if hr is not None and hr["reads"] is reads:
        return hr
    L = max((p.len for p in reads), default=1)
    planes = np.full((len(reads), 2, L), 4, np.uint8)
    for b, p in enumerate(reads):
        if not p.filtered:
            planes[b, 0, :p.len] = p.seq[:p.len]
            planes[b, 1, :p.len] = p.rseq[:p.len]
    hr = dict(reads=reads, planes=planes,
              lens=np.array([p.len for p in reads], np.int32),
              filtered=np.array([p.filtered for p in reads], bool))
    world["host_rows"] = hr
    return hr


def _max_diffs(lens: np.ndarray, opt) -> np.ndarray:
    """Each read's max-diff as NativeEngine.align_batch gives it: by its
    length when opt.fnr > 0, else opt.max_diff."""
    if opt.fnr <= 0.0:
        return np.full(lens.shape, opt.max_diff, np.int32)
    u, inv = np.unique(lens, return_inverse=True)
    md = np.array([bwa_cal_maxdiff(int(n), thres=opt.fnr) for n in u],
                  np.int32)
    return md[inv.reshape(-1)]


def _aln_rows(reads) -> tuple[np.ndarray, np.ndarray]:
    """(kept (n,), hits (sum(kept), 7)): each read's first A_MAX hits, in
    the engine's output layout (n_mm, n_gapo, n_gape, a, k, l, score)."""
    kept = np.array([min(len(p.aln), A_MAX) for p in reads], np.int32)
    hits = np.array([(a.n_mm, a.n_gapo, a.n_gape, a.a, a.k, a.l, a.score)
                     for p in reads for a in p.aln[:A_MAX]],
                    np.int32).reshape(-1, 7)
    return kept, hits


def _hit_index(kept: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(read, slot) of each of the hits, kept[i] a read, in read order."""
    b = np.repeat(np.arange(len(kept)), kept)
    return b, np.arange(len(b)) - (np.cumsum(kept) - kept)[b]


def _native_hits(world, engine: NativeEngine, rows: np.ndarray):
    """Redo the world's rows `rows` (none filtered) on the native engine.
    Returns (kept (n,): each row's hits in the fill, each such hit's row
    (an index into rows) and slot, the hits (n_mm, n_gapo, n_gape, a, k,
    l, score), the number of rows the Python oracle redid)."""
    hr = host_rows(world)
    opt = world["opt"]
    n = len(rows)
    lens = hr["lens"][rows]
    L = int(lens.max())
    seqs = np.ascontiguousarray(hr["planes"][rows, :, :L])
    mds = _max_diffs(lens, opt)
    batch_md = (bwa_cal_maxdiff(L, thres=opt.fnr) if opt.fnr > 0.0
                else opt.max_diff)
    cap = engine.OUT_CAP
    out = world.get("host_redo_out")
    if out is None or out.shape[0] < n or out.shape[1] != cap:
        # kept across calls: the engine writes only rows [0, out_n) of a
        # read, so a fresh buffer would cost its page faults every call
        out = np.empty((n, cap, 7), np.int32)
        world["host_redo_out"] = out
    out_n = np.empty(n, np.int32)
    cp = ctypes.c_void_p
    with spans.span("program.host_redo.native"):
        engine._lib.aln_batch(
            engine._h, seqs.ctypes.data_as(cp), lens.ctypes.data_as(cp),
            mds.ctypes.data_as(cp), n, L, opt.s_mm, opt.s_gapo, opt.s_gape,
            int(min(opt.max_gapo, batch_md)), opt.max_gape,
            opt.indel_end_skip, opt.max_del_occ, opt.max_entries,
            opt.max_top2, opt.seed_len, opt.max_seed_diff,
            out_n.ctypes.data_as(cp), out.ctypes.data_as(cp), cap)
    kept = np.clip(out_n, 0, A_MAX)
    b, j = _hit_index(kept)
    hits = out[b, j]
    over = np.nonzero(out_n < 0)[0]
    if len(over):  # more hits than OUT_CAP: the oracle redoes the read
        reads = [copy.copy(world["reads"][r]) for r in rows[over]]
        engine._host.align_batch(reads, opt)
        kept[over], hits_o = _aln_rows(reads)
        bo, jo = _hit_index(kept[over])
        b, j = np.concatenate([b, over[bo]]), np.concatenate([j, jo])
        hits = np.concatenate([hits, hits_o])
    return kept, b, j, hits, len(over)


def fill(world, engine, fb: np.ndarray, lo: int, B: int, dev):
    """The second pass's fill for a block of nb = len(fb) rows that starts
    at world row lo (rows from B on are padding, with no read), from the
    block's first-pass fallback flags fb: the fallback rows redone by
    `engine` (None: exact_engine) and packed as pack_host_hits packs
    them, as (fb_n (nb,), fb_rows (nb, A_MAX, 3)) int32 on dev.  Also
    returns the counts ``redo_rows`` (rows the engine redid: the fallback
    rows not filtered) and ``redo_oracle_rows`` (of them, the rows the
    Python oracle redid)."""
    nb = len(fb)
    rows_idx = np.nonzero(fb)[0]
    rows_idx = rows_idx[lo + rows_idx < B]
    if len(rows_idx) and engine is None:
        engine = exact_engine(world["idx"])
    if not isinstance(engine, NativeEngine):
        reads = [copy.copy(world["reads"][lo + b]) for b in rows_idx]
        if reads:
            engine.align_batch(reads, world["opt"])
        fb_n, fb_rows = pack_host_hits(reads, rows_idx, nb)
        n = sum(not p.filtered for p in reads)
        return ((torch.from_numpy(fb_n).to(dev),
                 torch.from_numpy(fb_rows).to(dev)),
                dict(redo_rows=n, redo_oracle_rows=n))
    redo = ~host_rows(world)["filtered"][lo + rows_idx]
    todo = rows_idx[redo]
    sub_n = np.zeros(len(rows_idx), np.int32)  # a filtered row: no hits
    pos, hits = np.zeros(0, np.int64), np.zeros((0, 7), np.int32)
    n_oracle = 0
    if len(todo):
        sub_n[redo], b, j, hits, n_oracle = _native_hits(world, engine,
                                                         lo + todo)
        pos = todo[b] * A_MAX + j
    words = np.stack(
        [hits[:, 0] | (hits[:, 1] << 6) | (hits[:, 2] << 12)
         | (hits[:, 3] << 18) | (hits[:, 6] << 19), hits[:, 4], hits[:, 5]],
        1)
    # only the redone rows cross to the device; the dense plane is made there
    fb_n = torch.full((nb,), -1, dtype=torch.int32, device=dev)
    fb_n[torch.from_numpy(rows_idx).to(dev)] = \
        torch.from_numpy(sub_n).to(dev)
    fb_rows = torch.zeros((nb * A_MAX, 3), dtype=torch.int32, device=dev)
    fb_rows[torch.from_numpy(pos).to(dev)] = torch.from_numpy(words).to(dev)
    return ((fb_n, fb_rows.view(nb, A_MAX, 3)),
            dict(redo_rows=len(todo), redo_oracle_rows=n_oracle))
