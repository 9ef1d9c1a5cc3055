"""The one-program step's exact redo of its first pass's fallback rows, and
the fill that carries their hit lists into the second pass
(``qc_step_full(fb_fill=...)``; qc_program.run_with_fill).

A fallback row whose only cause is a pool overflow is first searched again
on the rows' device (``card_retry``): the resident kernel's retry entry at
slabs 8x deeper a level, up to the 15-bit link's 32,767 slots, each level
taking the rows that overflowed the one before.  A read's result does not
depend on its pool depth unless the pool overflows, so a row the retry
finishes carries the exact engine's hits.  The retry searches as the exact
engine does: the first pass's padded length, step cap and chain length,
the engine's options, each row's max-diff by its length and the batch's
max_gapo.

The rows the retry does not finish go to the exact engine, by the route
that follows the engine:

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
on all the fallback rows followed by ``pack_host_hits``.  Only the rows
with a fill cross to the device; the dense ``(nb, A_MAX, 3)`` plane is
scattered there.
"""

from __future__ import annotations

import copy
import ctypes
import dataclasses

import numpy as np
import torch

from ..align.engine import NativeEngine
from ..align.opts import bwa_cal_maxdiff
from ..align.sample_setup import exact_engine
from ..utils import spans
from .batch_search import read_inputs
from .qc_full import pack_host_hits, search_params
from .search_kernels import A_MAX, FB_POOL, resident_search

RETRY_GROWTH = 8  # a retry level's slab over the level before
RETRY_MAX_NP = 32767  # the deepest slab: the next link is 15 bits
# bytes a retried row holds besides its slab (widths, seed widths, hits,
# read_inputs' temporaries), and a plain lane's bytes a pool slot
_ROW_BYTES = 1 << 14
_SLOT_BYTES = {"cuda": 18, "cpu": 40}
_CPU_RETRY_BYTES = 1 << 30  # the plain version's budget a launch


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


def _batch_max_gapo(lens: np.ndarray, opt) -> int:
    """max_gapo as the exact engine takes it for a batch of reads of
    lengths `lens` (none filtered): opt.max_gapo, at most the max-diff of
    the longest read (NativeEngine.align_batch)."""
    L = int(lens.max(initial=0))
    batch_md = (bwa_cal_maxdiff(L, thres=opt.fnr) if opt.fnr > 0.0
                else opt.max_diff)
    return int(min(opt.max_gapo, batch_md))


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


def _native_hits(world, engine: NativeEngine, rows: np.ndarray,
                 max_gapo: int):
    """Redo the world's rows `rows` (none filtered) on the native engine,
    at max_gapo (the batch's: _batch_max_gapo of every row the engine
    would take, when the retry has taken some of them).  Returns (kept
    (n,): each row's hits in the fill, each such hit's row (an index into
    rows) and slot, the hits (n_mm, n_gapo, n_gape, a, k, l, score), the
    number of rows the Python oracle redid)."""
    hr = host_rows(world)
    opt = world["opt"]
    n = len(rows)
    lens = hr["lens"][rows]
    L = int(lens.max())
    seqs = np.ascontiguousarray(hr["planes"][rows, :, :L])
    mds = _max_diffs(lens, opt)
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
            max_gapo, opt.max_gape,
            opt.indel_end_skip, opt.max_del_occ, opt.max_entries,
            opt.max_top2, opt.seed_len, opt.max_seed_diff,
            out_n.ctypes.data_as(cp), out.ctypes.data_as(cp), cap)
    kept = np.clip(out_n, 0, A_MAX)
    b, j = _hit_index(kept)
    hits = out[b, j]
    over = np.nonzero(out_n < 0)[0]
    if len(over):  # more hits than OUT_CAP: the oracle redoes the read
        reads = [copy.copy(world["reads"][r]) for r in rows[over]]
        engine._host.align_batch(reads, dataclasses.replace(
            opt, max_gapo=max_gapo))
        kept[over], hits_o = _aln_rows(reads)
        bo, jo = _hit_index(kept[over])
        b, j = np.concatenate([b, over[bo]]), np.concatenate([j, jo])
        hits = np.concatenate([hits, hits_o])
    return kept, b, j, hits, len(over)


def _retry_rows(n: int, NP: int, dev: torch.device) -> int:
    """Rows one retry launch at NP slots takes: its slabs in half the
    device's free memory (the allocator's cached blocks counted free), or
    the plain version's budget on the CPU."""
    if dev.type == "cuda":
        free = torch.cuda.mem_get_info(dev)[0] + (
            torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev))
        budget, slot = free // 2, _SLOT_BYTES["cuda"]
    else:
        budget, slot = _CPU_RETRY_BYTES, _SLOT_BYTES["cpu"]
    return max(1, min(n, budget // (NP * slot + _ROW_BYTES)))


def card_retry(world, rows: np.ndarray, max_gapo: int):
    """Search the world's rows `rows` (first-pass pool overflows, none
    filtered) again on the world's device at deeper slabs: level after
    level (RETRY_GROWTH x the slab before, the first pass's pool the first
    level's base, at most RETRY_MAX_NP), each level taking the rows whose
    only fallback cause at the level before was the pool, each launch as
    many rows as its slabs fit (_retry_rows).  The search is the exact
    engine's (the module's docstring), at max_gapo.

    Returns (done (n,) bool on the host: the rows the retry finished, their
    n_aln (n,) and hits (n, A_MAX, 3) int32 on the device, zero past a
    row's n_aln and on rows not done, the launches)."""
    seqs, _, _, _ = world["arrays"]
    fm, opt, dev = world["fm"], world["opt"], seqs.device
    n = len(rows)
    lens = host_rows(world)["lens"][rows]
    md = _max_diffs(lens, opt)
    P = dataclasses.replace(
        search_params(world["opt_args"], seqs.shape[1]), SL=opt.seed_len,
        s_mm=opt.s_mm, s_gapo=opt.s_gapo, s_gape=opt.s_gape,
        max_gapo=max_gapo, max_gape=opt.max_gape,
        indel_end_skip=opt.indel_end_skip, max_del_occ=opt.max_del_occ,
        max_entries=opt.max_entries, max_top2=opt.max_top2,
        max_seed_diff=opt.max_seed_diff)
    done = np.zeros(n, bool)
    out_n = torch.zeros(n, dtype=torch.int32, device=dev)
    out_hits = torch.zeros((n, A_MAX, 3), dtype=torch.int32, device=dev)
    slot = torch.arange(A_MAX, device=dev)
    todo, NP, launches = np.arange(n), P.NP, 0
    while len(todo) and NP < RETRY_MAX_NP:
        NP = min(NP * RETRY_GROWTH, RETRY_MAX_NP)
        Pk = dataclasses.replace(P, NP=NP)
        per = _retry_rows(len(todo), NP, dev)
        again = []
        for part in np.array_split(todo, -(-len(todo) // per)):
            r = torch.from_numpy(part).to(dev)
            ln = torch.from_numpy(lens[part]).to(dev)
            inp = read_inputs(fm, seqs[torch.from_numpy(rows[part]).to(dev)],
                              ln, torch.from_numpy(md[part]).to(dev),
                              ln > opt.seed_len, Pk)
            n_aln, hits, fb, _ = resident_search(fm, Pk, **inp, retry=True)
            del inp
            launches += 1
            fb = fb.cpu().numpy()
            ok = torch.from_numpy(fb == 0).to(dev)
            kept = ok[:, None] & (slot[None, :] < n_aln[:, None])
            out_n[r] = torch.where(ok, n_aln, 0)
            out_hits[r] = torch.where(kept[:, :, None], hits, 0)
            done[part] = fb == 0
            again.append(part[fb == FB_POOL])
        todo = np.concatenate(again)
    return done, out_n, out_hits, launches


def fill(world, engine, fb: np.ndarray, lo: int, B: int, dev):
    """The second pass's fill for a block of nb = len(fb) rows that starts
    at world row lo (rows from B on are padding, with no read), from the
    block's first-pass fallback bits fb (search_kernels.FB_*): the
    fallback rows' exact hits, packed as pack_host_hits packs them, as
    (fb_n (nb,), fb_rows (nb, A_MAX, 3)) int32 on dev.  The rows whose
    bits are FB_POOL alone (and not filtered) go to card_retry first; the
    rest of the fallback rows are redone by `engine` (None: exact_engine).

    Also returns the counts ``card_retry_rows`` (rows that entered the
    retry), ``card_retry_done`` (of them, the rows it finished),
    ``card_retry_launches``, ``redo_rows`` (rows the engine redid: the
    fallback rows neither filtered nor finished by the retry) and
    ``redo_oracle_rows`` (of them, the rows the Python oracle redid)."""
    nb = len(fb)
    rows_idx = np.nonzero(fb)[0]
    rows_idx = rows_idx[lo + rows_idx < B]
    filtered = host_rows(world)["filtered"][lo + rows_idx]
    unfilt = rows_idx[~filtered]
    # the engine's max_gapo follows its batch's longest read: every row,
    # retried or not, is searched at what the engine takes for all of them
    max_gapo = _batch_max_gapo(host_rows(world)["lens"][lo + unfilt],
                               world["opt"])
    retry = unfilt[fb[unfilt] == FB_POOL]
    with spans.span("program.host_redo.card"):
        done, r_n, r_hits, launches = card_retry(world, lo + retry, max_gapo)
    card = dict(card_retry_rows=len(retry), card_retry_done=int(done.sum()),
                card_retry_launches=launches)
    rest = np.setdiff1d(rows_idx, retry[done], assume_unique=True)
    if len(rest) and engine is None:
        engine = exact_engine(world["idx"])
    if not isinstance(engine, NativeEngine):
        reads = [copy.copy(world["reads"][lo + b]) for b in rest]
        if reads:
            engine.align_batch(reads, dataclasses.replace(
                world["opt"], max_gapo=max_gapo))
        fb_n, fb_rows = (torch.from_numpy(x).to(dev)
                         for x in pack_host_hits(reads, rest, nb))
        n = sum(not p.filtered for p in reads)
        counts = dict(redo_rows=n, redo_oracle_rows=n)
    else:
        redo = ~host_rows(world)["filtered"][lo + rest]
        todo = rest[redo]
        sub_n = np.zeros(len(rest), np.int32)  # a filtered row: no hits
        pos, hits = np.zeros(0, np.int64), np.zeros((0, 7), np.int32)
        n_oracle = 0
        if len(todo):
            sub_n[redo], b, j, hits, n_oracle = _native_hits(
                world, engine, lo + todo, max_gapo)
            pos = todo[b] * A_MAX + j
        words = np.stack(
            [hits[:, 0] | (hits[:, 1] << 6) | (hits[:, 2] << 12)
             | (hits[:, 3] << 18) | (hits[:, 6] << 19), hits[:, 4],
             hits[:, 5]], 1)
        # only the redone rows cross to the device; the dense plane is
        # made there
        fb_n = torch.full((nb,), -1, dtype=torch.int32, device=dev)
        fb_n[torch.from_numpy(rest).to(dev)] = torch.from_numpy(sub_n).to(dev)
        fb_rows = torch.zeros((nb * A_MAX, 3), dtype=torch.int32, device=dev)
        fb_rows[torch.from_numpy(pos).to(dev)] = \
            torch.from_numpy(words).to(dev)
        fb_rows = fb_rows.view(nb, A_MAX, 3)
        counts = dict(redo_rows=len(todo), redo_oracle_rows=n_oracle)
    if done.any():  # the retry's rows, already on the device
        fin = torch.from_numpy(np.nonzero(done)[0]).to(dev)
        at = torch.from_numpy(retry[done]).to(dev)
        fb_n[at] = r_n[fin].to(dev)
        fb_rows[at] = r_hits[fin].to(dev)
    return (fb_n, fb_rows), dict(card, **counts)
