"""Fused batched row moments of stacked sketches: the CUDA kernel
``csrc/fused_query.cu`` and its wrapper.

Replaces the Pallas TPU kernel ``fused_query_pallas`` of the JAX package.
This is the op's ``cuda_sm90`` tier in the kernel registry
(``kernels/ops.py``); its oracle is the plain version in :mod:`.ref`.  It
takes CUDA tensors only, launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import _build

launches = 0   # kernel launches since the last reset


def fused_query(counters_a: torch.Tensor, counters_b: torch.Tensor) -> torch.Tensor:
    """(N, L, t, w) x (N, L, t, w) int32 -> (N, L, t) float32 row moments
    sum_j A*B, exact in int64 and cast once."""
    global launches
    device = counters_a.device
    _build.require_cuda("fused_query", device)
    N, L, t, w = counters_a.shape
    _build.require("counters_a", counters_a, torch.int32, (N, L, t, w), device)
    _build.require("counters_b", counters_b, torch.int32, (N, L, t, w), device)
    out = torch.empty((N, L, t), dtype=torch.float32, device=device)
    rows = N * L * t
    if rows == 0:
        return out
    _build.launch("fused_query", device, counters_a.data_ptr(), counters_b.data_ptr(),
                  out.data_ptr(), rows, w)
    launches += 1
    return out
