"""Carry SJPC parameters and states between this package and numpy.

The JAX package's ``SJPCParams`` / ``SJPCState`` hold uint32 / int32 /
float32 arrays; as numpy arrays they come in here and go back out, so both
packages can hold the same sketch.
"""
from __future__ import annotations

import numpy as np
import torch

from . import platform
from .core.hashing import as_field_tensor
from .core.sjpc import SJPCParams, SJPCState


def params_from_numpy(bucket_coeffs, sign_coeffs, fp_bases, device=None) -> SJPCParams:
    """uint32 arrays (levels, t, 2, 4), (levels, t, 2, 4), (2,) -> params."""
    device = platform.resolve(device)
    return SJPCParams(*(as_field_tensor(np.asarray(a), device)
                        for a in (bucket_coeffs, sign_coeffs, fp_bases)))


def state_from_numpy(counters, n, step, device=None) -> SJPCState:
    """int32 counters (levels, t, w), float32 n, int32 step -> state."""
    device = platform.resolve(device)
    return SJPCState(
        counters=torch.from_numpy(np.array(counters, dtype=np.int32)).to(device),
        n=torch.tensor(np.float32(n), dtype=torch.float32, device=device),
        step=torch.tensor(np.int32(step), dtype=torch.int32, device=device))


def state_to_numpy(state: SJPCState) -> tuple[np.ndarray, np.float32, np.int32]:
    """state -> (int32 counters, float32 n, int32 step)."""
    return (state.counters.cpu().numpy().astype(np.int32),
            np.float32(state.n.cpu().item()), np.int32(state.step.cpu().item()))
