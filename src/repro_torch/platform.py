"""Device selection.

Entry points run on the CUDA card unless the caller names another device.
There is no quiet fallback: without a CUDA device, :func:`default_device`
raises, and a caller who wants the CPU passes ``device="cpu"``.
"""
from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The current CUDA device; raises ``RuntimeError`` when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means :func:`default_device`."""
    return default_device() if device is None else torch.device(device)
