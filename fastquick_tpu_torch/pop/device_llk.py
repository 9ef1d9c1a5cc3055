"""Device contamination-likelihood evaluator (PyTorch).

Counterpart of fastquick_tpu/pop/device_llk.py: ComputeMixLLKs (reference
VerifyBamID/ContaminationEstimator.h:206-281) over the estimator's
per-marker (class, qual)-bin count matrix, in float32 on a torch device:

    af        = clip((UD @ pc + mu) / 2)           # PCA AF model (h:236-250)
    base_lk   = counts @ log(v).T                  # (markers, 9)
    marker_ll = logsumexp(base_lk + log gf1 gf2)   # 3x3 genotype mixture
    llk       = sum(marker_ll)                     # over markers

The log-sum-exp is max-shifted as in the reference package; markers whose
mixture likelihood underflows (all-(-inf) rows) contribute 0, as the host
path's ``marker_lk > 0`` gate drops them.

The two products are elementwise products summed in float32, never a
cuBLAS matmul, so TF32 cannot apply whatever the process's global matmul
setting is: the analog of the reference's ``Precision.HIGHEST``.

``device=None`` means DEVICE_DEFAULT (``"cuda"``), resolved by
utils/device.resolve_device, which raises where torch sees no CUDA device;
``pop+con --device cpu`` sets DEVICE_DEFAULT for its run.  There is no
silent CPU path.

Over a parallel/mesh.Mesh the sum is marker-sharded, as the reference's
shard_map + psum: the markers are padded to a multiple of the ranks with
zero counts, af = 0.5 (means 1, UD 0) and contribute exactly 0; each rank
keeps its block of markers and the scalar is summed over the mesh's
groups (the chip level first).  Every rank then holds the same value, so
an optimizer driven by it takes the same path on every rank.  The ranks
must hold the same inputs: the constructor compares a digest of them
over the mesh and raises on every rank where they differ.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..utils.device import resolve_device
from .estimator import LK_ERR, LK_NOERR, MAX_AF, MIN_AF, N_CLASS, N_QBINS

# the device of DeviceLLK(device=None); pop+con --device sets it for its run
DEVICE_DEFAULT = "cuda"


def _same_inputs(mesh, axes: tuple, dev: torch.device, arrays) -> None:
    """Raise ValueError on every rank unless every rank of the mesh's
    `axes` was given the same arrays: a rank estimating another sample
    would add its likelihood into this one's."""
    h = hashlib.blake2b(digest_size=8)
    for a in arrays:
        a = None if a is None else np.ascontiguousarray(a)
        h.update(repr(None if a is None else (a.dtype.str, a.shape))
                 .encode())
        if a is not None:
            h.update(a.tobytes())
    mine = torch.tensor(int.from_bytes(h.digest(), "little", signed=True),
                        dtype=torch.int64, device=dev)
    for ax in axes:
        if (mesh.all_gather(mine, ax) != mine).any():
            raise ValueError(
                f"DeviceLLK over the mesh: the ranks of axis {ax!r} hold "
                f"different counts, UD, means or known_af; every rank must "
                f"estimate the same sample")


class DeviceLLK:
    """llk(pc1, pc2, alpha) -> float, in float32 on one torch device;
    optionally marker-sharded over a mesh's `axis` (a name or a tuple).

    Counts, UD, means and known_af are uploaded once, here (on a mesh,
    this rank's block); each call moves only pc1, pc2 and alpha to the
    device."""

    def __init__(self, counts: np.ndarray, UD: np.ndarray, means: np.ndarray,
                 known_af: np.ndarray | None = None, mesh=None,
                 axis: str | tuple = "dp",
                 device: str | torch.device | None = None):
        self._mesh, self._axes = mesh, ()
        self.device = resolve_device(DEVICE_DEFAULT if device is None
                                     else device)
        if mesh is not None:
            from ..parallel.mesh import Mesh, local_rows

            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a parallel.mesh.Mesh, not "
                                f"{type(mesh).__name__}")
            self._axes = (axis,) if isinstance(axis, str) else tuple(axis)
            _same_inputs(mesh, self._axes, self.device,
                         (counts, UD, means, known_af))
            n = int(np.prod([mesh.axis_size(a) for a in self._axes]))
            M, pad = counts.shape[0], (-counts.shape[0]) % n
            if pad:
                counts = np.concatenate(
                    [counts, np.zeros((pad,) + counts.shape[1:],
                                      counts.dtype)])
                UD = np.concatenate([UD, np.zeros((pad,) + UD.shape[1:],
                                                  UD.dtype)])
                means = np.concatenate([means, np.ones(pad, means.dtype)])
                if known_af is not None:
                    known_af = np.concatenate(
                        [known_af, np.full(pad, 0.5, known_af.dtype)])
            lo, per = local_rows(mesh, M + pad, self._axes)
            counts, UD, means = (a[lo: lo + per] for a in (counts, UD, means))
            if known_af is not None:
                known_af = known_af[lo: lo + per]
        dev, f32 = self.device, torch.float32

        # per-bin error rate and conditional-LK tables tiled over bins
        q = np.arange(N_QBINS, dtype=np.float64)
        eps = np.tile(np.power(10.0, q / -10.0), N_CLASS)
        cls = np.repeat(np.arange(N_CLASS), N_QBINS)

        def up(a):
            return torch.as_tensor(np.asarray(a), dtype=f32, device=dev)

        self._counts = up(counts)
        self._UD = up(UD)
        self._means = up(means)
        self._known_af = None if known_af is None else up(known_af)
        self._eps = up(eps)
        self._lk_err = up(LK_ERR[:, cls])  # (3, bins)
        self._lk_noerr = up(LK_NOERR[:, cls])
        self._log2 = torch.log(torch.tensor(2.0, dtype=f32, device=dev))
        self._tiny = torch.tensor(np.finfo(np.float32).tiny, dtype=f32,
                                  device=dev)

    def _log_gf(self, af: torch.Tensor) -> torch.Tensor:
        """log genotype frequencies [(1-af)^2, 2af(1-af), af^2], (M, 3)."""
        la, l1a = torch.log(af), torch.log1p(-af)
        return torch.stack([2.0 * l1a, self._log2 + la + l1a, 2.0 * la],
                           dim=1)

    def _af(self, pc: torch.Tensor) -> torch.Tensor:
        if self._known_af is not None:
            return self._known_af.clamp(MIN_AF, MAX_AF)
        return ((self._UD * pc).sum(1) + self._means).mul(0.5).clamp(
            MIN_AF, MAX_AF)

    def llk(self, pc1: torch.Tensor, pc2: torch.Tensor,
            alpha: torch.Tensor) -> torch.Tensor:
        """The likelihood as a 0-d float32 tensor on the device."""
        lg1, lg2 = self._log_gf(self._af(pc1)), self._log_gf(self._af(pc2))
        e_mix = (alpha * self._lk_err[:, None, :]
                 + (1 - alpha) * self._lk_err[None, :, :])
        n_mix = (alpha * self._lk_noerr[:, None, :]
                 + (1 - alpha) * self._lk_noerr[None, :, :])
        v = e_mix * self._eps + n_mix * (1 - self._eps)  # (3, 3, bins)
        logv = torch.log(torch.maximum(v, self._tiny)).reshape(9, -1)
        base_lk = (self._counts[:, None, :] * logv[None]).sum(2)  # (M, 9)
        tot = base_lk + (lg1[:, :, None] + lg2[:, None, :]).reshape(-1, 9)
        m = tot.max(dim=1).values
        ll = m + torch.log(torch.exp(tot - m[:, None]).sum(dim=1))
        # all-underflow markers are dropped (reference marker_lk>0 gate)
        ll = torch.where(torch.isfinite(ll), ll, 0.0).sum()
        for ax in reversed(self._axes):  # the chip level first
            ll = self._mesh.psum(ll, ax)
        return ll

    def __call__(self, pc1, pc2, alpha: float) -> float:
        def up(x):
            return torch.as_tensor(np.asarray(x, np.float64),
                                   dtype=torch.float32, device=self.device)

        return float(self.llk(up(pc1), up(pc2), up(float(alpha))))
