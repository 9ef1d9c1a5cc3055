"""Device drand48 multi-hit selection: bwa_aln2seq_core's reservoir draw
(reference libbwa/bwase.c:19-44) over a batch of hit lists in read order.

Counterpart of fastquick_tpu/ops/drand48_device.py.  The reference seeds
srand48(11) once per mapper and consumes one global sequential stream
across every read's hit list: per best-class entry one draw decides the
reservoir acceptance (``drand48() * (width + cnt) > cnt``), and each
acceptance takes a second draw for the SA-row offset (``k + (bwtint_t)
(width * drand48())``).

The stream is sequential (read r+1's draws depend on how many reads r
consumed), but most of its consumption is known in advance: a read with
an empty best class takes no draw, a read whose best class is one row
takes two unless its first draw is 0.  ``aln2seq_draw_scan`` launches the
CUDA kernel (csrc/drand48.cu) for CUDA tensors: per tile of reads, a
parallel pass classifies the reads, one thread walks only the reads of
larger best classes, crossing each run of single-row reads with one affine
jump of the LCG, then every single-row read draws from its own start state
in parallel; a first draw of 0 ends the tile there and the walk resumes
after it.  Its arithmetic is C's: a uint64 LCG and IEEE double
multiplies.  CPU tensors run the plain version (``draw_scan_plain``:
Python ints and floats, which are C doubles, read by read).  The stream
state goes in and out as the reference package's four 12-bit limbs
(``seed_state``), so a batch's ``_drand_state`` continues the next
batch's stream in either package.

Exactness domain: the stream matches the host oracle for every read the
search kernel finished (fallback reads consume their draws on the host
instead), so a production check fills the fallback reads first
(qc_full's ``fb_fill``, qc_program.run_with_fill).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..kernels import build

A48 = 0x5DEECE66D
C48 = 0xB
NL = 4  # state limbs (48 bits, 12-bit limbs)
_MASK48 = (1 << 48) - 1


def seed_state(seed: int = 11) -> np.ndarray:
    """srand48: x = (seed << 16) | 0x330E, as 12-bit limbs."""
    x = ((seed & 0xFFFFFFFF) << 16) | 0x330E
    return np.array([(x >> (12 * i)) & 0xFFF for i in range(NL)], np.int32)


def best_class(n_aln: torch.Tensor, alns: torch.Tensor) -> torch.Tensor:
    """(N,) rows of each read's best class: the rows among its first n_aln
    that carry row 0's score (the rows are recorded best score first)."""
    A = alns.shape[1]
    score = (alns[:, :, 0] >> 19) & 127
    used = torch.arange(A, device=alns.device)[None, :] < n_aln[:, None]
    return (used & (score == score[:, :1])).sum(1)


def draw_scan_plain(n_aln: torch.Tensor, alns: torch.Tensor, state0,
                    stats: dict | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the draw: the same walk in Python ints (the
    48-bit LCG) and floats (IEEE doubles, as C's).  stats: a dict that
    receives the walk's draws (LCG steps) as "draws"."""
    dev = alns.device
    nb = best_class(n_aln, alns).tolist()
    rows = alns.cpu().numpy()
    x = sum(int(v) << (12 * i) for i, v in enumerate(
        torch.as_tensor(state0).tolist()))
    f0 = np.zeros(len(nb), np.int32)
    row = np.zeros(len(nb), np.int32)
    draws = 0
    for r, n in enumerate(nb):
        cnt = 0
        for i in range(n):
            w = int(rows[r, i, 2]) - int(rows[r, i, 1]) + 1
            x = (A48 * x + C48) & _MASK48
            draws += 1
            if (x / float(1 << 48)) * (w + cnt) > cnt:
                x = (A48 * x + C48) & _MASK48
                draws += 1
                f0[r] = rows[r, i, 0]
                row[r] = int(rows[r, i, 1]) + int(w * (x / float(1 << 48)))
            cnt += w
    if stats is not None:
        stats["draws"] = draws
    state = torch.tensor([(x >> (12 * i)) & 0xFFF for i in range(NL)],
                         dtype=torch.int32, device=dev)
    return (torch.from_numpy(f0).to(dev), torch.from_numpy(row).to(dev),
            state)


def aln2seq_draw_scan(n_aln: torch.Tensor, alns: torch.Tensor, state0
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The global reservoir-draw scan over a batch in row order.

    n_aln: (N,) hits per read (0 = filtered/empty: consumes no draws,
    bwase.c:21).  alns: (N, A_MAX, 3) packed rows [mm|go<<6|ge<<12|a<<18|
    score<<19, k, l] in nondecreasing score order.  state0: (4,) limb LCG
    state (a tensor on alns' device, or an array).  Returns (sel_f0,
    sel_row, state_out), int32: the selected entry's field word and SA row
    per read (zeros when no acceptance happened -- C's calloc'd
    bwa_seq_t), and the evolved stream state for the next batch."""
    if alns.device.type == "cpu":
        return draw_scan_plain(n_aln, alns, state0)
    dev = alns.device
    i32 = torch.int32
    state_in = torch.as_tensor(state0, dtype=i32, device=dev).contiguous()
    build.require_cuda(n_aln, alns, state_in)
    N = n_aln.shape[0]
    if alns.shape != (N, 48, 3):
        raise ValueError(f"alns must be (N, 48, 3), got {tuple(alns.shape)}")
    n32 = n_aln.to(i32).contiguous()
    a32 = alns.to(i32).contiguous()
    f0 = torch.zeros(N, dtype=i32, device=dev)
    row = torch.zeros(N, dtype=i32, device=dev)
    state = torch.empty(NL, dtype=i32, device=dev)
    p = build.ptr
    rc = build.cuda_library().fq_drand48_launch(
        p(n32), p(a32), N, p(state_in), p(f0), p(row), p(state),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    build.check(rc, "drand48")
    build.launch_counts["drand48"] += 1
    return f0, row, state


class HostDraw:
    """Python mirror of the scan (oracle for tests; exact ints)."""

    def __init__(self, seed: int = 11):
        self.x = ((seed & 0xFFFFFFFF) << 16) | 0x330E

    def step(self) -> int:
        self.x = (A48 * self.x + C48) & _MASK48
        return self.x

    def accept(self, W: int, cnt: int) -> bool:
        return (self.step() / float(1 << 48)) * W > cnt

    def sa_off(self, w: int) -> int:
        return int(w * (self.step() / float(1 << 48)))
