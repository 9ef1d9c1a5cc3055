"""Smith-Waterman forward kernel (CUDA, csrc/sw.cu) with its plain PyTorch
version, and the mate-rescue glue around it.

``sw_forward_batch`` replaces the Pallas _sw_kernel (fastquick_tpu/ops/
sw_pallas.py:52): the forward pass of aln_local_core (libbwa/stdaln.c:
529-745) for a batch of (ref window, read) jobs -- best score and 1-based
end cell, scoring match 11, mismatch -19, vs-N -13, gap open 26 + extend
9, with the C code's freeze-F rule (stdaln.c:278-284).  For CUDA tensors
it launches the kernel; for CPU tensors it runs ``sw_forward_plain``,
vectorised over jobs and ref columns, with the horizontal gap of each row
resolved by the gated max-plus scan (cumsum / cummax) iterated to its
fixpoint, as the TPU kernel did.

``sw_local_batch_device`` is the counterpart of sw_pallas.py:193-262:
forward launch, reversed-prefix launch, then the host global path.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..kernels import build
from ..utils.spans import span

MATCH, MISMATCH, VS_N = 11, -19, -13
GAP_OPEN, GAP_EXT = 26, 9
QR = GAP_OPEN + GAP_EXT
NEG = -(1 << 20)


def sw_forward_plain(refs: torch.Tensor, queries: torch.Tensor,
                     rlens: torch.Tensor, qlens: torch.Tensor
                     ) -> torch.Tensor:
    """Plain version of the SW forward kernel (same contract as
    sw_forward_batch)."""
    dev = refs.device
    B, RL = refs.shape
    QL = queries.shape[1]
    refs = refs.long()
    queries = queries.long()
    lane = torch.arange(RL, device=dev)[None, :]
    ref_valid = lane < rlens.long()[:, None]
    qlens = qlens.long()
    h_prev = torch.zeros((B, RL), dtype=torch.long, device=dev)
    e_prev = torch.zeros_like(h_prev)
    best = torch.zeros((B, 3), dtype=torch.long, device=dev)
    zcol = torch.zeros((B, 1), dtype=torch.long, device=dev)
    for i in range(QL):
        q = queries[:, i:i + 1]
        valid = ref_valid & (i < qlens[:, None])
        is_n = (q == 4) | (refs == 4)
        m = torch.where(is_n, VS_N, torch.where(refs == q, MATCH, MISMATCH))
        diag = torch.cat([zcol, h_prev[:, :-1]], 1)
        base = (diag + m).clamp(min=0)
        e_new = torch.maximum(e_prev - GAP_EXT, h_prev - QR).clamp(min=0)
        hnf = torch.where(valid, torch.maximum(base, e_new), 0)
        h = hnf
        while True:
            # freeze-F: f_k = gate_k ? max(f_{k-1} - r, h_{k-1} - qr) :
            # f_{k-1} with gate_k = h_{k-1} > 0 is an affine max-plus scan
            # given the gates; iterate it to the serial fixpoint
            h_left = torch.cat([zcol, h[:, :-1]], 1)
            gate = h_left > 0
            acc_a = torch.where(gate, -GAP_EXT, 0).cumsum(1)
            b = torch.where(gate, h_left - QR, NEG)
            acc_m = torch.cummax(b - acc_a, 1).values
            f = acc_a + acc_m.clamp(min=0)
            h_new = torch.where(gate & valid, torch.maximum(hnf, f), hnf)
            if torch.equal(h_new, h):
                break
            h = h_new
        h_prev = h
        e_prev = torch.where(valid, e_new, 0)
        row_best, row_arg = h.max(1)
        better = row_best > best[:, 0]
        new = torch.stack([row_best, row_arg + 1,
                           torch.full_like(row_best, i + 1)], 1)
        best = torch.where(better[:, None], new, best)
    out = torch.zeros((B, 4), dtype=torch.int32, device=dev)
    out[:, :3] = best.to(torch.int32)
    return out


def sw_forward_batch(refs: torch.Tensor, queries: torch.Tensor,
                     rlens: torch.Tensor, qlens: torch.Tensor
                     ) -> torch.Tensor:
    """Batched local SW forward pass.

    refs: (B, RL) codes 0..4; queries: (B, QL); rlens/qlens: (B,).
    Returns (B, 4) int32 [best_score, end_i (ref, 1-based), end_j (query,
    1-based), 0]; a zero score means no local match."""
    if refs.device.type == "cpu":
        return sw_forward_plain(refs, queries, rlens, qlens)
    build.require_cuda(refs, queries, rlens, qlens)
    (B, RL), QL = refs.shape, queries.shape[1]
    dev = refs.device
    refs8 = refs.to(torch.uint8).contiguous()
    qs8 = queries.to(torch.uint8).contiguous()
    rl32 = rlens.to(torch.int32).contiguous()
    ql32 = qlens.to(torch.int32).contiguous()
    out = torch.empty((B, 4), dtype=torch.int32, device=dev)
    lib = build.cuda_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = build.ptr
    rc = lib.fq_sw_launch(p(refs8), p(qs8), p(rl32), p(ql32), B, RL, QL,
                          p(out), ctypes.c_void_p(stream))
    build.check(rc, "sw")
    build.launch_counts["sw"] += 1
    return out


def sw_local_batch_device(jobs: list[tuple[np.ndarray, np.ndarray]],
                          device: str | torch.device = "cuda",
                          thres: int = 1) -> list:
    """Full aln_local_core over a batch of (ref, query) jobs with the DP
    passes on the device: one forward launch finds (score, end), one launch
    on the reversed matched prefixes finds the start, then the banded
    global path runs on the host exactly as the C does (the global aligner
    is align/dp.global_cigar).  Returns per job (score, cigar, (si, sj,
    ei, ej, bi, bj)), the contract of align/dp.local_align."""
    from ..align.dp import FROM_D, FROM_I, global_cigar

    n = len(jobs)
    if n == 0:
        return []
    dev = torch.device(device)
    RL = max(-(-max(len(r) for r, _ in jobs) // 128) * 128, 128)
    QL = max(-(-max(len(q) for _, q in jobs) // 128) * 128, 128)

    def run(refs, qs, rl, ql):
        # one device pass: the copies in, the kernel and the copy back
        with span("sw.device"):
            return sw_forward_batch(
                torch.from_numpy(refs).to(dev), torch.from_numpy(qs).to(dev),
                torch.from_numpy(rl).to(dev),
                torch.from_numpy(ql).to(dev)).cpu().numpy()

    refs = np.zeros((n, RL), np.uint8)
    qs = np.zeros((n, QL), np.uint8)
    rl = np.zeros(n, np.int32)
    ql = np.zeros(n, np.int32)
    for i, (r, q) in enumerate(jobs):
        refs[i, :len(r)] = r
        qs[i, :len(q)] = q
        rl[i], ql[i] = len(r), len(q)
    fwd = run(refs, qs, rl, ql)
    # reverse pass on reversed matched prefixes (only surviving jobs)
    live = [i for i in range(n) if fwd[i, 0] >= thres and fwd[i, 1] > 0]
    rr = np.zeros((len(live), RL), np.uint8)
    rq = np.zeros((len(live), QL), np.uint8)
    rrl = np.zeros(len(live), np.int32)
    rql = np.zeros(len(live), np.int32)
    for j, i in enumerate(live):
        ei, ej = int(fwd[i, 1]), int(fwd[i, 2])
        rr[j, :ei] = jobs[i][0][:ei][::-1]
        rq[j, :ej] = jobs[i][1][:ej][::-1]
        rrl[j], rql[j] = ei, ej
    rev = run(rr, rq, rrl, rql) if live else None
    out = []
    rev_of = {i: j for j, i in enumerate(live)}
    for i in range(n):
        score = int(fwd[i, 0])
        if i not in rev_of:
            out.append((score if score else -1, [],
                        (0, 0, int(fwd[i, 1]), int(fwd[i, 2]), 0, 0)))
            continue
        j = rev_of[i]
        ei, ej = int(fwd[i, 1]), int(fwd[i, 2])
        si = ei - int(rev[j, 1]) + 1
        sj = ej - int(rev[j, 2]) + 1
        sub1 = jobs[i][0][si - 1:ei]
        sub2 = jobs[i][1][sj - 1:ej]
        cigar = global_cigar(np.asarray(sub1, np.uint8),
                             np.asarray(sub2, np.uint8))
        # begin cell of the global path (= local_align's bi/bj): the first
        # step lands on (1,1) for M, (1,0) for D, (0,1) for I
        op0 = cigar[0][0] if cigar else 0
        bi = 0 if op0 == FROM_I else 1
        bj = 0 if op0 == FROM_D else 1
        out.append((score, cigar, (si, sj, ei, ej, bi, bj)))
    return out
