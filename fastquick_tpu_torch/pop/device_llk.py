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
silent CPU path.  The marker-sharded sum over a mesh is not ported: any
``mesh`` raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .estimator import LK_ERR, LK_NOERR, MAX_AF, MIN_AF, N_CLASS, N_QBINS

# the device of DeviceLLK(device=None); pop+con --device sets it for its run
DEVICE_DEFAULT = "cuda"


class DeviceLLK:
    """llk(pc1, pc2, alpha) -> float, in float32 on one torch device.

    Counts, UD, means and known_af are uploaded once, here; each call moves
    only pc1, pc2 and alpha to the device."""

    def __init__(self, counts: np.ndarray, UD: np.ndarray, means: np.ndarray,
                 known_af: np.ndarray | None = None, mesh=None,
                 axis: str = "dp", device: str | torch.device | None = None):
        if mesh is not None:
            raise NotImplementedError(
                "DeviceLLK over a mesh (the marker-sharded sum) is not "
                "ported yet: it belongs to the mesh slice of the port")
        self.device = resolve_device(DEVICE_DEFAULT if device is None
                                     else device)
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
        return torch.where(torch.isfinite(ll), ll, 0.0).sum()

    def __call__(self, pc1, pc2, alpha: float) -> float:
        def up(x):
            return torch.as_tensor(np.asarray(x, np.float64),
                                   dtype=torch.float32, device=self.device)

        return float(self.llk(up(pc1), up(pc2), up(float(alpha))))
