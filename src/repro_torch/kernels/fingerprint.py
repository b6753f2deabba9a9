"""Sub-value fingerprints: the CUDA kernel ``csrc/fingerprint.cu`` and its
wrapper.

Replaces the Pallas TPU kernel ``fingerprint_pallas`` of the JAX package.
This is the op's ``cuda_sm90`` tier in the kernel registry
(``kernels/ops.py``); its oracle is the plain version in :mod:`.ref`.  It
takes CUDA tensors only, launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import _build

launches = 0   # kernel launches since the last reset


def fingerprint(values: torch.Tensor, combo_masks: torch.Tensor, combo_ids: torch.Tensor,
                bases: torch.Tensor):
    """values (B, d) int64 x combos (M, d) int64 -> (fp1, fp2), each (B, M)
    int64 in [0, 2^31-1)."""
    global launches
    device = values.device
    _build.require_cuda("fingerprint", device)
    B, d = values.shape
    M = combo_ids.shape[0]
    _build.require("values", values, torch.int64, (B, d), device)
    _build.require("combo_masks", combo_masks, torch.int64, (M, d), device)
    _build.require("combo_ids", combo_ids, torch.int64, (M,), device)
    _build.require("bases", bases, torch.int64, (2,), device)
    fp1 = torch.empty((B, M), dtype=torch.int64, device=device)
    fp2 = torch.empty((B, M), dtype=torch.int64, device=device)
    if B * M == 0:
        return fp1, fp2
    _build.launch("fingerprint", device, values.data_ptr(), combo_masks.data_ptr(),
                  combo_ids.data_ptr(), bases.data_ptr(), fp1.data_ptr(), fp2.data_ptr(),
                  B, M, d)
    launches += 1
    return fp1, fp2
