"""Unfused Fast-AGMS update of one sketch: the CUDA kernel
``csrc/sketch_update.cu`` and its wrapper.

Replaces the Pallas TPU kernel ``sketch_update_pallas`` of the JAX package.
This is the op's ``cuda_sm90`` tier in the kernel registry
(``kernels/ops.py``); its oracle is :func:`.ref.sketch_update_ref`.  It
takes CUDA tensors only, launches the kernel or raises.  One launch per
call writes the new counters into a fresh tensor; the input counters are
only read.
"""
from __future__ import annotations

import torch

from . import _build

launches = 0   # kernel launches since the last reset


def sketch_update(counters: torch.Tensor, fp1: torch.Tensor, fp2: torch.Tensor,
                  bucket_coeffs: torch.Tensor, sign_coeffs: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """counters (t, w) int32; fp1, fp2 (N,) int64 field elements; coeffs
    (t, 2, 4) int64; weights (N,) int32.  Returns new (t, w) counters."""
    global launches
    device = counters.device
    _build.require_cuda("sketch_update", device)
    t, w = counters.shape
    n = fp1.shape[0]
    if w < 1 or w & (w - 1):
        raise ValueError(f"sketch width must be a power of two, got {w}")
    _build.require("counters", counters, torch.int32, (t, w), device)
    _build.require("fp1", fp1, torch.int64, (n,), device)
    _build.require("fp2", fp2, torch.int64, (n,), device)
    _build.require("bucket_coeffs", bucket_coeffs, torch.int64, (t, 2, 4), device)
    _build.require("sign_coeffs", sign_coeffs, torch.int64, (t, 2, 4), device)
    _build.require("weights", weights, torch.int32, (n,), device)
    out = torch.empty_like(counters)
    if t == 0:
        return out
    _build.launch("sketch_update", device, out.data_ptr(), counters.data_ptr(),
                  fp1.data_ptr(), fp2.data_ptr(), weights.data_ptr(), bucket_coeffs.data_ptr(),
                  sign_coeffs.data_ptr(), n, t, w)
    launches += 1
    return out
