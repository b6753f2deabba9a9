"""All-pairs similarity histograms of stacked samples: the CUDA kernel
``csrc/fused_pairs.cu`` and its wrapper.

Replaces the Pallas TPU kernel ``fused_pairs_pallas`` of the JAX package.
This is the op's ``cuda_sm90`` tier in the kernel registry
(``kernels/ops.py``); its oracle is :func:`.ref.fused_pairs_ref`.  It takes
CUDA tensors only, launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import _build

launches = 0   # kernel launches since the last reset

MAX_D = 16     # the kernel keeps d <= 16 columns (17 bins) in registers


def fused_pairs(items: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """items (N, R, d) integer words, valid (N, R) -> (N, d+1) int32: the
    ordered pairs (a != b, both valid) of each sample agreeing on exactly
    k columns.

    The kernel compares 32-bit words: items held as int64 (uint32 values,
    the port's storage) are narrowed to int32 here, which keeps each
    value's bit pattern and so every equality."""
    global launches
    device = items.device
    _build.require_cuda("fused_pairs", device)
    N, R, d = items.shape
    if not 1 <= d <= MAX_D:
        raise ValueError(f"fused_pairs takes 1 <= d <= {MAX_D} columns, got {d}")
    if items.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"items: expected int32 or int64, got {items.dtype}")
    words = items.to(torch.int32).contiguous()
    if words.data_ptr() % 16:   # the kernel copies rows in 16-byte words
        words = words.clone()
    flags = (valid != 0).to(torch.int32).contiguous()
    _build.require("valid", flags, torch.int32, (N, R), device)
    out = torch.zeros((N, d + 1), dtype=torch.int32, device=device)
    if N * R == 0:
        return out
    _build.launch("fused_pairs", device, words.data_ptr(), flags.data_ptr(), out.data_ptr(),
                  N, R, d)
    launches += 1
    return out
