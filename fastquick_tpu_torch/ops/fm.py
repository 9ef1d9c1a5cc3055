"""Device FM-index primitives in PyTorch (plain tensor code).

Counterpart of fastquick_tpu/ops/fm.py: libbwa's rank machinery
(bwt_occ / bwt_2occ4, libbwa/bwt.h:98-226 with the __occ_aux popcount
trick :89-96) over the same layout:

- BWT packed 16 bases per 32-bit word (base j at bits 2*(15 - j)), one
  Occ block of 8 words = 128 bases per row; Occ checkpoints per block as a
  separate (n_blocks+1, 4) array.  Torch has no uint32 arithmetic or
  popcount op, so the words ride int32 tensors (same bit pattern) and
  every bit trick below runs in int64 masked to 32 bits, with a SWAR
  popcount.
- Forward and reverse indexes are stacked along a leading axis; a per-row
  strand selector picks the index.

These functions are the plain versions of the CUDA kernels in
ops/search_kernels.py (which read ``DeviceFM.kernel_table()``, the same
rows fused to 64 bytes: occ[4] | words[8] | pad[4]).  All row arithmetic
follows BWA's closed-interval convention [k, l] with occ(c, k) counting
rows [0..k].
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..index.fmindex import BASES_PER_WORD, OCC_BLOCK, FMIndex
from ..utils.device import resolve_device

WORDS_PER_BLOCK = OCC_BLOCK // BASES_PER_WORD  # 8
TAB_WIDTH = 16  # int32 per fused kernel-table row: occ[4] words[8] pad[4]

M32 = 0xFFFFFFFF
_EVEN_BITS = 0x55555555
_PATTERNS = (0x00000000, 0x55555555, 0xAAAAAAAA, 0xFFFFFFFF)


@dataclass
class DeviceFM:
    """Stacked forward+reverse FM index arrays on one torch device."""

    words: torch.Tensor  # (2, nb, 8) int32: bit pattern of the uint32 words
    occ: torch.Tensor  # (2, nb, 4) int32
    sa: torch.Tensor  # (2, n+1) int32
    L2: torch.Tensor  # (2, 4) int32 (BWA L2: #chars < c)
    primary: torch.Tensor  # (2,) int32
    n: int  # text length (same both directions)
    primary_host: tuple = (0, 0)
    L2_host: tuple = ((0, 0, 0, 0), (0, 0, 0, 0))
    _tab: torch.Tensor | None = field(default=None, repr=False)

    @classmethod
    def from_numpy(cls, words: np.ndarray, occ: np.ndarray, sa: np.ndarray,
                   L2: np.ndarray, primary: np.ndarray, n: int,
                   device: str | torch.device = "cpu") -> "DeviceFM":
        """Take the fields of the JAX DeviceFM as numpy arrays (words as
        uint32 or int32).  On the CPU the tensors share the arrays' memory
        (torch.from_numpy, no copy)."""
        device = torch.device(device)

        def put(a, dtype):
            a = np.ascontiguousarray(a)
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            t = torch.from_numpy(a.astype(dtype, copy=False))
            return t if device.type == "cpu" else t.to(device)

        L2 = np.asarray(L2)
        primary = np.asarray(primary)
        return cls(words=put(words, np.int32), occ=put(occ, np.int32),
                   sa=put(sa, np.int32), L2=put(L2, np.int32),
                   primary=put(primary, np.int32), n=int(n),
                   primary_host=tuple(int(p) for p in primary.reshape(-1)),
                   L2_host=tuple(tuple(int(v) for v in row)
                                 for row in L2.reshape(2, 4)))

    @classmethod
    def build(cls, fm_fwd: FMIndex, fm_rev: FMIndex,
              device: str | torch.device = "cuda") -> "DeviceFM":
        """The device layout of the two FM indexes on `device` (the card
        unless "cpu"; cuda without a usable CUDA device raises)."""
        device = resolve_device(device)

        def prep_words(fm):
            # one Occ block (8 words = 128 bases) per row, +1 guard block
            w = fm.bwt_words
            nb = -(-len(w) // WORDS_PER_BLOCK) + 1
            out = np.zeros(nb * WORDS_PER_BLOCK, dtype=np.uint32)
            out[: len(w)] = w
            return out.reshape(nb, WORDS_PER_BLOCK)

        words = np.stack([prep_words(fm_fwd), prep_words(fm_rev)])
        occ = np.stack([fm_fwd.occ, fm_rev.occ]).astype(np.int32)
        sa = np.stack([fm_fwd.sa, fm_rev.sa]).astype(np.int32)
        L2 = np.stack([(fm_fwd.C[:4] - 1),
                       (fm_rev.C[:4] - 1)]).astype(np.int32)
        primary = np.array([fm_fwd.primary, fm_rev.primary], dtype=np.int32)
        return cls.from_numpy(words, occ, sa, L2, primary, fm_fwd.n, device)

    @property
    def device(self) -> torch.device:
        return self.words.device

    def kernel_table(self) -> torch.Tensor:
        """(2 * nbp, 16) int32 rows [occ0..3, word0..7, 0 x 4] for the CUDA
        kernels: one 64-byte row per rank query (the ~6.5 MB table of the
        production panel stays in the H100's 50 MB L2)."""
        if self._tab is None:
            nbp = max(self.words.shape[1], self.occ.shape[1])
            tab = torch.zeros((2, nbp, TAB_WIDTH), dtype=torch.int32,
                              device=self.device)
            tab[:, : self.occ.shape[1], 0:4] = self.occ
            tab[:, : self.words.shape[1], 4:12] = self.words
            self._tab = tab.reshape(2 * nbp, TAB_WIDTH).contiguous()
        return self._tab

    def kernel_table_bytes(self) -> int:
        """The size of kernel_table() in bytes, without building it."""
        return 2 * max(self.words.shape[1], self.occ.shape[1]) * TAB_WIDTH * 4

    def host_params(self) -> np.ndarray:
        """[n, nbp, primary0, primary1, L2 fwd x4, L2 rev x4] int32, the
        scalar part of the kernels' FM view."""
        nbp = self.kernel_table().shape[0] // 2
        return np.array([self.n, nbp, *self.primary_host,
                         *self.L2_host[0], *self.L2_host[1]], np.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 values in [0, 2^32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def _word_prefix_counts(words8: torch.Tensor, prefix: torch.Tensor
                        ) -> torch.Tensor:
    """Count each base c in the first prefix[..., w] bases of each word.

    words8: (..., 8) int64 in [0, 2^32); prefix: (..., 8) in [0, 16].
    Returns (..., 4) int64 counts."""
    shift = 32 - 2 * prefix  # in [0, 32]; a 32-bit shift masks to 0
    mask = (M32 << shift) & M32
    pats = torch.tensor(_PATTERNS, dtype=torch.int64, device=words8.device)
    x = words8.unsqueeze(-2) ^ pats[:, None]  # (..., 4, 8)
    y = x | (x >> 1)
    match = (~y) & _EVEN_BITS & mask.unsqueeze(-2)
    return popcount32(match).sum(dim=-1)


def occ4(fm: DeviceFM, sel: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Batched bwt_occ4: counts of each base in BWT rows [0..k] of the
    index selected by ``sel`` (0 = forward, 1 = reverse); k in [-1, n].

    sel, k: (B,) integer tensors.  Returns (B, 4) int64."""
    sel = sel.long()
    kk = k.long() + 1  # half-open bound over n+1 rows
    primary = fm.primary.long()[sel]
    kp = (kk - (kk > primary).long()).clamp(0, fm.n)
    block = kp // OCC_BLOCK
    rem = kp - block * OCC_BLOCK
    ck = fm.occ[sel, block].long()
    words8 = fm.words[sel, block.clamp(0, fm.words.shape[1] - 1)].long() & M32
    offs = torch.arange(WORDS_PER_BLOCK, device=kp.device) * BASES_PER_WORD
    prefix = (rem[:, None] - offs[None, :]).clamp(0, BASES_PER_WORD)
    return ck + _word_prefix_counts(words8, prefix)


def occ4_pair(fm: DeviceFM, sel: torch.Tensor, ka: torch.Tensor,
              kb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two occ4 queries per row through one table gather."""
    B = sel.shape[0]
    both = occ4(fm, torch.cat([sel, sel]), torch.cat([ka, kb]))
    return both[:B], both[B:]


def occ1(fm: DeviceFM, sel: torch.Tensor, k: torch.Tensor,
         c: torch.Tensor) -> torch.Tensor:
    """Batched single-char occ: counts of base c in rows [0..k]."""
    return occ4(fm, sel, k).gather(1, c.long()[:, None])[:, 0]


def backward_ext(fm: DeviceFM, sel: torch.Tensor, k: torch.Tensor,
                 l: torch.Tensor, c: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One backward-search step: closed interval [k, l] extended by c."""
    c = c.long()
    ok4, ol4 = occ4_pair(fm, sel, k - 1, l)
    L2c = fm.L2.long()[sel.long(), c]
    ok = ok4.gather(1, c[:, None])[:, 0]
    ol = ol4.gather(1, c[:, None])[:, 0]
    return L2c + ok + 1, L2c + ol


def sa_lookup(fm: DeviceFM, sel: torch.Tensor, row: torch.Tensor
              ) -> torch.Tensor:
    """SA value for rows (one gather; replaces the bwt_sa walk)."""
    return fm.sa[sel.long(), row.long()]


def _selector(sel, B: int, device) -> torch.Tensor:
    if isinstance(sel, torch.Tensor):
        return sel.to(device=device, dtype=torch.long).expand(B)
    return torch.full((B,), int(sel), dtype=torch.long, device=device)


def cal_width_planes(fm: DeviceFM, sel, seqs: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw per-position (w, bid) planes of bwt_cal_width
    (libbwa/bwtaln.c:73-97) for (B, L) codes 0..4 -- the plain version of
    the width kernel.  sel: scalar or per-row selector.  Returns two
    (B, L) int32 tensors, before the terminal entry (width_finalize)."""
    B, L = seqs.shape
    dev = seqs.device
    sel = _selector(sel, B, dev)
    n = fm.n
    k = torch.zeros(B, dtype=torch.long, device=dev)
    l = torch.full((B,), n, dtype=torch.long, device=dev)
    bid = torch.zeros(B, dtype=torch.long, device=dev)
    w_out = torch.empty((B, L), dtype=torch.int32, device=dev)
    b_out = torch.empty((B, L), dtype=torch.int32, device=dev)
    for i in range(L):
        c = seqs[:, i].long()
        valid_c = c < 4
        nk, nl = backward_ext(fm, sel, k, l, c.clamp(0, 3))
        nk = torch.where(valid_c, nk, k)
        nl = torch.where(valid_c, nl, l)
        restart = (nk > nl) | ~valid_c
        bid = bid + restart.long()
        k = torch.where(restart, 0, nk)
        l = torch.where(restart, n, nl)
        w_out[:, i] = l - k + 1
        b_out[:, i] = bid
    return w_out, b_out


def width_finalize(w: torch.Tensor, bid: torch.Tensor, lens: torch.Tensor
                   ) -> torch.Tensor:
    """(B, L) per-position (w, bid) planes -> the (B, L+1, 2) int32 width
    array with bwt_cal_width's terminal entry: width[len] = (0, bid at
    len-1, plus 1).  Shared by the plain path and the width kernel."""
    B, L = w.shape
    lens = lens.long()
    width = torch.zeros((B, L + 1, 2), dtype=torch.int32, device=w.device)
    width[:, :L, 0] = w
    width[:, :L, 1] = bid
    last = bid.gather(1, (lens - 1).clamp(0, max(L - 1, 0))[:, None])[:, 0]
    last = torch.where(lens > 0, last, torch.zeros_like(last))
    rows = torch.arange(B, device=w.device)
    width[rows, lens, 0] = 0
    width[rows, lens, 1] = last + 1
    return width


def cal_width(fm: DeviceFM, sel, seqs: torch.Tensor,
              lens: torch.Tensor) -> torch.Tensor:
    """Batched bwt_cal_width: (B, L+1, 2) int32 [w, bid]; the entry at
    index lens[b] holds (0, bid_final + 1)."""
    w, bid = cal_width_planes(fm, sel, seqs)
    return width_finalize(w, bid, lens)


def match_exact(fm: DeviceFM, sel_scalar: int, seqs: torch.Tensor,
                lens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched full-read exact backward search; closed [k, l] (k > l
    means no match)."""
    B, L = seqs.shape
    dev = seqs.device
    sel = _selector(sel_scalar, B, dev)
    lens = lens.long()
    n = fm.n
    k = torch.zeros(B, dtype=torch.long, device=dev)
    l = torch.full((B,), n, dtype=torch.long, device=dev)
    dead = torch.zeros(B, dtype=torch.bool, device=dev)
    for i in range(L):
        idx = lens - 1 - i
        active = (i < lens) & ~dead
        c = seqs.gather(1, idx.clamp(0, L - 1)[:, None])[:, 0].long()
        bad = c > 3
        nk, nl = backward_ext(fm, sel, k, l, c.clamp(0, 3))
        ok = active & ~bad
        k = torch.where(ok, nk, k)
        l = torch.where(ok, nl, l)
        dead = dead | (active & (bad | (k > l)))
    k = torch.where(dead, 1, k)
    l = torch.where(dead, 0, l)
    return k, l
