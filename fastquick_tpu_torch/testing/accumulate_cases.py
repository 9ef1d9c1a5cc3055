"""Seeded inputs of the per-base accumulation (ops/accumulate), shared by
tests/test_torch_accumulate.py and chip_smoke.py.

A world is a random text with markers where ``synthetic_site_tables``
puts them (evenly spaced, each with a window of dense sites).  A case is
one batch of placed reads over it, as numpy arrays:

- ``qc_case``: the one-program step's inputs (int32 planes in read
  orientation as bwa stores them, lens, pos, strand, eligible, mapq, the
  pileup cap and marker_base).  Every read's position is one an index
  whose suffix array is the identity would give: strand 0 in [-len,
  n_text - len], strand 1 in [0, n_text] (``search_rows`` makes the hit
  rows that place it so), so a case also runs through both packages'
  whole step with the search stubbed out.
- ``ref_case``: DeviceDenseStats' inputs (uint8 codes and quals in
  reference orientation, the quals after - 33 with uint8 wrap).

``recorded_launches`` and ``check_launches`` hold every accumulation of a
one-program run on the card (accumulate_pileup: a walk and an order
launch) to the plain versions after it (in this process: a mesh rank
records its own).

The reads are the text with a share of substitutions and N codes, on
both strands; options reach the edges: ragged lengths, reads past the
text's end or before its start, qualities above 93 or below 0, long
reads (cycles past 255 and 1023), deep markers past the pileup cap, slot
offsets, no eligible read.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import numpy as np

from ..ops.search_kernels import A_MAX


def _mpos(n_text: int, n_markers: int, flank: int):
    """synthetic_site_tables' marker positions (evenly spaced)."""
    return np.linspace(flank, n_text - flank - 1, n_markers).astype(np.int64)


# The edge cases: name -> (world (n_text, n_markers, flank), batch (B, L),
# qc_case options); "marker_at_zero" is "mixed" with a fifth of the reads
# before the text's start and marker 0 also at pac 0 (edge_tables)
QC_EDGE = {
    "mixed": ((6000, 10, 60), (300, 100), dict(
        past_end=0.05, before_start=0.03, q_range=(-5, 120),
        mapq_max=200, deep_markers=3, deep_reads=40, pileup_cap=16)),
    "offsets": ((6000, 10, 60), (300, 100), dict(
        past_end=0.05, q_range=(0, 100), deep_markers=3, deep_reads=40,
        pileup_cap=16, marker_base=True)),
    "long": ((3000, 6, 100), (24, 300), dict(
        deep_markers=2, deep_reads=10, pileup_cap=8, marker_base=True)),
    # cycles past 1,023 on a marker: strand 0 at base 1,050, strand 1 at 20
    "longest": ((4000, 8, 100), (8, 1100), dict(
        deep_markers=2, deep_reads=3, pileup_cap=8, p_eligible=1.0,
        first=((int(_mpos(4000, 8, 100)[3]) - 1050, 0, 1100),
               (int(_mpos(4000, 8, 100)[2]) - 20, 1, 1100)))),
    "no_eligible": ((6000, 10, 60), (50, 100), dict(p_eligible=0.0)),
    "one_read": ((6000, 10, 60), (1, 100), dict(
        p_eligible=1.0, first=((int(_mpos(6000, 10, 60)[4]) - 30, 1, 80),))),
}
# name -> (world, batch (B, L), ref_case options)
REF_EDGE = {
    "chunk": ((6000, 10, 60), (500, 150), dict(
        past_end=0.05, wrap=0.02, deep_markers=3, deep_reads=40)),
    "clipped": ((3000, 6, 100), (40, 256), dict(wrap=0.05)),
    "one_read": ((6000, 10, 60), (1, 120), dict(
        first=((int(_mpos(6000, 10, 60)[4]) - 30, 1, 120),))),
    "narrow": ((600, 2, 50), (7, 3), {}),
}


def edge_case(name: str, ref: bool = False):
    """(world spec, text, case) of an edge case (QC_EDGE plus
    "marker_at_zero", or REF_EDGE), seeded by its name."""
    qc = "mixed" if name == "marker_at_zero" else name
    spec, (B, L), kw = REF_EDGE[name] if ref else QC_EDGE[qc]
    rng = np.random.default_rng(sum(map(ord, name)))
    text, mpos = world(rng, *spec)
    if ref:
        return spec, text, ref_case(rng, text, mpos, B, L, **kw)
    if name == "marker_at_zero":
        kw = dict(kw, before_start=0.2)
    return spec, text, qc_case(rng, text, mpos, B, L, **kw)


def edge_tables(name: str, spec, text, device):
    """An edge case's site tables on `device` (synthetic_site_tables;
    "marker_at_zero" also puts marker 0 at pac 0, a dense site)."""
    from ..ops.qc_full import synthetic_site_tables

    t = synthetic_site_tables(text, spec[1], spec[2], device=device)
    if name == "marker_at_zero":
        t.marker_id[0] = 0
    return t


def mark_every_site(tables) -> None:
    """Put a marker at every dense site of `tables` (marker site % M, in
    place): each base in a region becomes a pileup entry."""
    import torch

    site = tables.site_idx
    tables.marker_id[:] = torch.where(site >= 0, site % tables.n_markers,
                                      -1).to(tables.marker_id.dtype)


def world(rng: np.random.Generator, n_text: int, n_markers: int,
          flank: int):
    """(text uint8, marker positions): the positions are
    synthetic_site_tables' (its markers evenly spaced)."""
    return rng.integers(0, 4, n_text).astype(np.uint8), _mpos(
        n_text, n_markers, flank)


def _placements(rng, n_text: int, mpos, B: int, L: int, ragged: bool,
                past_end: float, before_start: float, deep_markers: int,
                deep_reads: int, first: tuple = ()):
    """lens, pos, strand of B reads: uniform over the text, a share past
    its end (strand 1) or before its start (strand 0, pos -len),
    deep_reads reads over each of the first deep_markers markers, and the
    first rows placed as `first` says ((pos, strand, len) each)."""
    lens = (rng.integers(1, L + 1, B) if ragged
            else np.full(B, L)).astype(np.int64)
    strand = rng.integers(0, 2, B).astype(np.int64)
    hi = np.maximum(n_text - lens, 0)
    pos = (rng.random(B) * (hi + 1)).astype(np.int64)
    u = rng.random(B)
    end = u < past_end
    strand[end] = 1
    pos[end] = n_text - (rng.random(int(end.sum())) * lens[end]).astype(
        np.int64)
    start = (u >= past_end) & (u < past_end + before_start)
    strand[start] = 0
    pos[start] = -lens[start]
    n_deep = min(deep_markers * deep_reads, B)
    if n_deep:
        at = np.arange(n_deep)
        m = mpos[at % deep_markers]
        off = (rng.random(n_deep) * lens[at]).astype(np.int64)
        pos[at] = np.clip(m - off, 0, None)
        strand[at] = np.where(pos[at] + lens[at] > n_text, 1, strand[at])
        # strand 0 must keep pos <= n_text - len (the identity index)
        pos[at] = np.where(strand[at] == 0,
                           np.minimum(pos[at], hi[at]), pos[at])
        perm = rng.permutation(B)  # spread over the batch
        lens, pos, strand = lens[perm], pos[perm], strand[perm]
    for r, (p, s, n) in enumerate(first):
        pos[r], strand[r], lens[r] = p, s, n
    return lens, pos, strand


def _reference_segments(rng, text, lens, pos, L: int, mism: float,
                        n_rate: float):
    """(B, L) the reference bases under each read (4 off the text and past
    its length), with substitutions and N codes."""
    n_text = len(text)
    B = len(lens)
    j = np.arange(L)[None, :]
    p = pos[:, None] + j
    ref = np.where((p >= 0) & (p < n_text),
                   text[np.clip(p, 0, n_text - 1)], 4).astype(np.int32)
    sub = rng.random((B, L)) < mism
    ref = np.where(sub, (ref + rng.integers(1, 4, (B, L))) % 4, ref)
    ref = np.where(rng.random((B, L)) < n_rate, 4, ref)
    return np.where(j < lens[:, None], ref, 4).astype(np.int32)


def _store(a, lens):
    """bwa's stored reversal of each row's first len entries (4 after)."""
    L = a.shape[1]
    j = np.arange(L)[None, :]
    k = np.clip(lens[:, None] - 1 - j, 0, L - 1)
    return np.where(j < lens[:, None], np.take_along_axis(a, k, 1),
                    4).astype(np.int32)


def qc_case(rng: np.random.Generator, text, mpos, B: int, L: int, *,
            ragged: bool = True, past_end: float = 0.02,
            before_start: float = 0.0, deep_markers: int = 0,
            deep_reads: int = 0, q_range: tuple = (2, 42),
            mapq_max: int = 60, p_eligible: float = 0.85,
            mism: float = 0.01, n_rate: float = 0.002,
            pileup_cap: int = 64, marker_base: bool = False,
            first: tuple = ()) -> dict:
    """One batch of the one-program step's accumulation inputs.  A row
    is bwa's store of a read that is the reference segment (strand 0) or
    its reverse complement (strand 1): seqs the read reversed, rseqs its
    reverse complement; quals in read order, q_range inclusive; marker_base: random slot offsets 0..cap + 2 (some
    past the cap) instead of none; first: _placements'."""
    M = len(mpos)
    lens, pos, strand = _placements(rng, len(text), mpos, B, L, ragged,
                                    past_end, before_start, deep_markers,
                                    deep_reads, first)
    ref = _reference_segments(rng, text, lens, pos, L, mism, n_rate)
    comp = np.where(ref < 4, 3 - ref, 4)
    rev = (strand == 1)[:, None]
    j = np.arange(L)[None, :]
    quals = np.where(j < lens[:, None],
                     rng.integers(q_range[0], q_range[1] + 1, (B, L)),
                     0).astype(np.int32)
    return dict(
        seqs=np.where(rev, comp, _store(ref, lens)),
        rseqs=np.where(rev, ref, _store(comp, lens)), quals=quals,
        lens=lens, pos=pos, strand=strand,
        eligible=rng.random(B) < p_eligible,
        mapq=rng.integers(0, mapq_max + 1, B).astype(np.int64),
        pileup_cap=pileup_cap,
        marker_base=(rng.integers(0, pileup_cap + 3, M).astype(np.int32)
                     if marker_base else None))


def ref_case(rng: np.random.Generator, text, mpos, B: int, L: int, *,
             past_end: float = 0.02, deep_markers: int = 0,
             deep_reads: int = 0, wrap: float = 0.0,
             mism: float = 0.01, n_rate: float = 0.002,
             first: tuple = ()) -> dict:
    """One chunk of DeviceDenseStats' inputs (L <= 256): uint8 codes in
    reference orientation, quals as phred + 33 characters less 33 in
    uint8 (a share `wrap` of characters below 33 wraps past 255),
    lens/pos/strand int64; first: _placements'."""
    lens, pos, strand = _placements(rng, len(text), mpos, B, L, True,
                                    past_end, 0.0, deep_markers, deep_reads,
                                    first)
    codes = _reference_segments(rng, text, lens, pos, L, mism, n_rate)
    j = np.arange(L)[None, :]
    chars = rng.integers(35, 75, (B, L))
    chars = np.where(rng.random((B, L)) < wrap, rng.integers(0, 33, (B, L)),
                     chars)
    quals = np.where(j < lens[:, None], (chars.astype(np.uint8)
                                         - np.uint8(33)), 0)
    return dict(codes=codes.astype(np.uint8), quals=quals.astype(np.uint8),
                lens=lens, pos=pos, strand=strand)


def search_rows(case: dict, n_text: int):
    """(n_aln (B,), alns (B, A_MAX, 3)) int32 hit rows that place each
    eligible read of a qc_case at its pos and strand through an index
    whose suffix arrays are the identity (SA row k: pos k on strand 1,
    n_text - k - len on strand 0), one row of width 1 (mapQ 37); of the
    others, even rows unmapped and odd rows gapped (one gap open)."""
    B = len(case["lens"])
    n_aln = np.zeros(B, np.int32)
    alns = np.zeros((B, A_MAX, 3), np.int32)
    strand = case["strand"].astype(np.int64)
    k = np.where(strand == 1, case["pos"],
                 n_text - case["lens"] - case["pos"])
    elig = case["eligible"]
    gapped = ~elig & (np.arange(B) % 2 == 1)
    n_aln[elig | gapped] = 1
    alns[:, 0, 0] = np.where(n_aln > 0, (strand << 18) | (60 << 19)
                             | np.where(gapped, 1 << 6, 0), 0)
    alns[:, 0, 1] = np.where(n_aln > 0, k, 0)
    alns[:, 0, 2] = alns[:, 0, 1]
    return n_aln, alns


@contextlib.contextmanager
def recorded_launches(calls: list):
    """Record each accumulate_pileup call qc_step_full makes on the card
    inside the block (one walk and one order launch each) into calls as
    (args, outputs): the per-read fields and the outputs copied, the
    planes and tables as the caller's (the step does not write them)."""
    import torch

    from ..ops import qc_full

    def keep(a):
        return a.clone() if isinstance(a, torch.Tensor) and a.dim() < 2 \
            else a

    fn = qc_full.accumulate_pileup

    def run(*args):
        out = fn(*args)
        calls.append((tuple(keep(a) for a in args),
                      {k: v.clone() for k, v in out.items()}))
        return out

    with mock.patch.object(qc_full, "accumulate_pileup", run):
        yield


def same_outputs(got: dict, want: dict, what: str) -> None:
    """Raise unless two accumulations agree in every output's names,
    dtype, shape and value."""
    import torch

    if got.keys() != want.keys():
        raise AssertionError(f"{what}: outputs {sorted(got)} != "
                             f"{sorted(want)}")
    for k, w in want.items():
        g = got[k]
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{what}: {k} {g.dtype}{tuple(g.shape)} "
                                 f"!= {w.dtype}{tuple(w.shape)}")
        if not torch.equal(g, w):
            bad = (g != w).reshape(-1).nonzero()[:5].flatten().tolist()
            raise AssertionError(f"{what}: {k} differs at {bad}")


def check_launches(calls: list, what: str) -> list:
    """Each recorded call against the plain versions on its own inputs
    (raises unless equal); returns (B, L, marker_base: None, or its
    largest slot offset) of each."""
    from ..ops import accumulate as acc

    out = []
    for i, (args, got) in enumerate(calls):
        want = acc.step_outputs(acc.accumulate_plain(*args[:9]),
                                 acc.pileup_plain(*args))
        same_outputs(got, want, f"{what}, accumulation {i} != plain")
        mb = args[-1]
        out.append((*args[2].shape, None if mb is None else int(mb.max())))
    return out
