"""Device k-mer read filter (K1) in plain PyTorch.

Counterpart of fastquick_tpu/ops/kmer.py: the six-projection rolling-hash
filter (reference src/BwtIndexer.h:262-315, src/BwtIndexer.cpp:498-543).
The 6 x 512 MiB bitmaps live on the device as int32 words (the bit
pattern of the uint32 words); each read contributes its first three
non-overlapping 32-mers; each 32-mer is projected six ways and the vote
count compared with the threshold.

The 64-bit k-mer register is carried as (hi, lo) 32-bit halves held in
int64 tensors and masked to 32 bits after every shift, which reproduces
the reference's N-value bit spill across the half boundary (value 4 =
0b100 leaks its top bit into the neighbouring base's field) bit for bit.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from ..utils.device import resolve_device

KMER_SIZE = 32
N_TABLES = 6
TABLE_WORDS = 1 << 27  # 2^32 bits per table as 32-bit words
M32 = 0xFFFFFFFF


def load_kmer_bitmaps(bitmaps: np.ndarray | Sequence[np.ndarray],
                      device: str | torch.device = "cuda"
                      ) -> torch.Tensor | list[torch.Tensor]:
    """The filter's bitmaps as int32 words on `device`.

    bitmaps: the (6, 2^27) uint32 array of KmerFilter.bitmaps_uint32(), or
    the sequence of six 512 MiB per-table bitmaps of
    KmerFilter.byte_bitmaps() (uint8 byte layout; the same bits as the
    little-endian words).  On the CPU nothing is copied: the result wraps
    the arrays (torch.from_numpy) -- one (6, 2^27) tensor, or a list of six
    (2^27,) tensors for a sequence.  On a CUDA device the tables are
    uploaded one by one into one (6, 2^27) tensor.  The card unless
    `device` is "cpu"; cuda without a usable CUDA device raises."""
    device = resolve_device(device)
    if (isinstance(bitmaps, np.ndarray) and bitmaps.ndim == 2
            and device.type == "cpu"):
        return torch.from_numpy(np.ascontiguousarray(bitmaps).view(np.int32))
    words = [torch.from_numpy(np.ascontiguousarray(r).view(np.int32))
             for r in bitmaps]
    if len(words) != N_TABLES or any(w.shape != (TABLE_WORDS,)
                                     for w in words):
        shapes = [tuple(w.shape) for w in words]
        raise ValueError(f"expected {N_TABLES} bitmaps of {TABLE_WORDS} "
                         f"32-bit words, got {shapes}")
    if device.type == "cpu":
        return words
    out = torch.empty((N_TABLES, TABLE_WORDS), dtype=torch.int32,
                      device=device)
    for t, w in enumerate(words):
        out[t].copy_(w)
    return out


def kmer_halves(chunks: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """chunks: (..., 32) base codes (0..4).  Returns (hi, lo) int64 in
    [0, 2^32): the two halves of the 64-bit OR-register."""
    v = chunks.long()
    hi = torch.zeros(chunks.shape[:-1], dtype=torch.long,
                     device=chunks.device)
    lo = torch.zeros_like(hi)
    for j in range(16):
        hi = hi | ((v[..., j] << (30 - 2 * j)) & M32)
    hi = hi | (v[..., 16] >> 2)  # N bit spill across the boundary
    for j in range(16, 32):
        lo = lo | ((v[..., j] << (2 * (31 - j))) & M32)
    return hi, lo


def projections(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Six 32-bit shrinkage projections; returns (..., 6) int64."""
    hi = hi.long() & M32
    lo = lo.long() & M32
    p0 = hi
    p1 = lo
    p2 = (hi & 0xFFFF0000) | (lo & 0xFFFF)
    p3 = ((hi << 16) & M32) | (lo >> 16)
    p4 = (hi & 0xFFFF0000) | (lo >> 16)
    p5 = ((hi << 16) & M32) | (lo & 0xFFFF)
    return torch.stack([p0, p1, p2, p3, p4, p5], dim=-1)


def filter_reads(bitmaps: torch.Tensor | list[torch.Tensor],
                 seqs: torch.Tensor, lens: torch.Tensor,
                 thresh: int = 3) -> torch.Tensor:
    """Batched IsReadFiltered inverted: True = read KEPT.

    bitmaps: (6, 2^27) int32, or a list of six (2^27,) int32 tables, as
    load_kmer_bitmaps returns them (bit k at word k >> 5, bit k & 31);
    seqs: (B, L) codes; lens: (B,).  Counts accumulate across the first 3
    in-bounds chunks (IsReadInHashByCountMoreChunck semantics with the
    over-read clamped)."""
    B, L = seqs.shape
    dev = seqs.device
    count = torch.zeros(B, dtype=torch.long, device=dev)
    tables = torch.arange(N_TABLES, device=dev)[None, :]
    lens = lens.long()
    for chunk in range(3):
        s, e = chunk * KMER_SIZE, (chunk + 1) * KMER_SIZE
        if e > L:
            break
        in_bounds = lens >= e
        hi, lo = kmer_halves(seqs[:, s:e])
        projs = projections(hi, lo)  # (B, 6)
        widx = projs >> 5
        if isinstance(bitmaps, torch.Tensor):
            words = bitmaps[tables, widx]  # (B, 6) int32
        else:
            words = torch.stack([bitmaps[t][widx[:, t]]
                                 for t in range(N_TABLES)], 1)
        # an arithmetic shift of the int32 word leaves bit `b` at bit 0
        hits = ((words >> (projs & 31)) & 1).sum(dim=1)
        count = count + torch.where(in_bounds, hits, 0)
    return count >= thresh
