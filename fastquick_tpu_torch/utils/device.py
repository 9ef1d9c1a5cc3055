"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  There is
no probe and no automatic fallback: asking for ``cuda`` on a host without
a usable CUDA device raises.
"""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    """``"cuda"`` (or ``"cuda:N"``) or ``"cpu"`` -> torch.device.

    Raises RuntimeError for ``cuda`` when torch sees no CUDA device."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass --device cpu to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return dev
