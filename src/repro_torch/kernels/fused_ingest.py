"""Fused fingerprint -> multi-level sketch ingest: the CUDA kernel
``csrc/fused_ingest.cu`` and its wrapper.

Replaces the Pallas TPU kernel ``fused_ingest_pallas`` of the JAX package.
This is the op's ``cuda_sm90`` tier in the kernel registry
(``kernels/ops.py``); its oracle is the plain version in :mod:`.ref`.  It
takes CUDA tensors only, launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import _build

launches = 0   # kernel launches since the last reset


def fused_ingest(counters: torch.Tensor, values: torch.Tensor, masks: torch.Tensor,
                 ids: torch.Tensor, bases: torch.Tensor, bucket_coeffs: torch.Tensor,
                 sign_coeffs: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """One launch: records -> fingerprints -> every level's sketch.

    counters (L, t, w) int32; values (B, d) int64; masks (L, m_max, d) and
    ids (L, m_max) int64, the padded lattice; bases (2,) int64;
    bucket/sign_coeffs (L, t, 2, 4) int64; weights (B, L, m_max) int32, 0
    in padded slots and masked-out rows.  Returns new (L, t, w) counters.
    """
    global launches
    device = counters.device
    _build.require_cuda("fused_ingest", device)
    L, t, w = counters.shape
    B, d = values.shape
    m_max = ids.shape[1]
    if w & (w - 1):
        raise ValueError(f"sketch width must be a power of two, got {w}")
    _build.require("counters", counters, torch.int32, (L, t, w), device)
    _build.require("values", values, torch.int64, (B, d), device)
    _build.require("masks", masks, torch.int64, (L, m_max, d), device)
    _build.require("ids", ids, torch.int64, (L, m_max), device)
    _build.require("bases", bases, torch.int64, (2,), device)
    _build.require("bucket_coeffs", bucket_coeffs, torch.int64, (L, t, 2, 4), device)
    _build.require("sign_coeffs", sign_coeffs, torch.int64, (L, t, 2, 4), device)
    _build.require("weights", weights, torch.int32, (B, L, m_max), device)
    out = torch.empty_like(counters)
    out.copy_(counters)
    if B * m_max * L == 0:
        return out
    _build.launch("fused_ingest", device, out.data_ptr(), values.data_ptr(), masks.data_ptr(),
                  ids.data_ptr(), bases.data_ptr(), bucket_coeffs.data_ptr(),
                  sign_coeffs.data_ptr(), weights.data_ptr(), B, L, m_max, d, t, w)
    launches += 1
    return out
