"""Row moments of one sketch pair: the CUDA kernel
``csrc/sketch_moments.cu`` and its wrapper.

Replaces the Pallas TPU kernel ``sketch_moments_pallas`` of the JAX
package.  This is the op's ``cuda_sm90`` tier in the kernel registry
(``kernels/ops.py``); its oracle is :func:`.ref.sketch_moments_ref`.  It
takes CUDA tensors only, launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import _build

launches = 0   # kernel launches since the last reset


def sketch_moments(counters_a: torch.Tensor, counters_b: torch.Tensor) -> torch.Tensor:
    """(t, w) x (t, w) int32 -> (t,) float32 row moments sum_j A*B, exact
    in int64 and cast once."""
    global launches
    device = counters_a.device
    _build.require_cuda("sketch_moments", device)
    t, w = counters_a.shape
    _build.require("counters_a", counters_a, torch.int32, (t, w), device)
    _build.require("counters_b", counters_b, torch.int32, (t, w), device)
    out = torch.empty((t,), dtype=torch.float32, device=device)
    if t == 0:
        return out
    _build.launch("sketch_moments", device, counters_a.data_ptr(), counters_b.data_ptr(),
                  out.data_ptr(), t, w)
    launches += 1
    return out
