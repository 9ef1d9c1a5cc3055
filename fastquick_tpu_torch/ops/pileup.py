"""Device pileup / statistics accumulators (K4) in plain PyTorch.

Counterpart of fastquick_tpu/ops/pileup.py: the reference's StatCollector
scatter-adds (src/StatCollector.cpp:342-422: per-base depth, Q20/Q30
depth, the quality histogram) as integer index_add_ sums over the
reduced-reference coordinate space.  Every accumulator is a commutative
integer sum, so a multi-device merge is an all-reduce.
"""

from __future__ import annotations

import torch


def depth_pileup(positions: torch.Tensor, lens: torch.Tensor,
                 mapped: torch.Tensor, quals: torch.Tensor,
                 n_ref: int) -> dict:
    """Accumulate per-position depth and Q20/Q30 depth for gapless
    alignments.

    positions: (B,) pac start positions; lens: (B,); mapped: (B,) bool;
    quals: (B, L) phred values (0 where padded).
    Returns dict of (n_ref,) int32 depth arrays + (256,) qual histogram.
    """
    B, L = quals.shape
    dev = quals.device
    offs = torch.arange(L, device=dev)[None, :]
    valid = mapped[:, None] & (offs < lens.long()[:, None])
    # unmapped bases and positions past the reference's end go to the
    # guard bin n_ref, which is cut off (the reference drops them)
    pos = positions.long()[:, None] + offs
    pos_c = torch.where(valid & (pos <= n_ref), pos, n_ref).reshape(-1)
    quals = quals.long()

    def add(n, idx, ones):
        return torch.zeros(n, dtype=torch.long, device=dev).index_add_(
            0, idx, ones.reshape(-1).long()).to(torch.int32)

    return {"depth": add(n_ref + 1, pos_c, valid)[:n_ref],
            "q20": add(n_ref + 1, pos_c, valid & (quals >= 20))[:n_ref],
            "q30": add(n_ref + 1, pos_c, valid & (quals >= 30))[:n_ref],
            "qual_hist": add(256, torch.where(valid, quals, 255).reshape(-1)
                             .clamp(0, 255), valid)}
