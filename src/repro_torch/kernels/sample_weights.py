"""SJPC's per-record projection sampling: the CUDA kernel
``csrc/sample_weights.cu`` and its wrapper.

Replaces ``_sample_level_weights`` of the JAX package's ``core/sjpc.py``,
which XLA compiles on the accelerator (no Pallas kernel).  This is the op's
``cuda_sm90`` tier in the kernel registry (``kernels/ops.py``); its oracle
is :func:`.ref.sample_weights_ref`.  It takes CUDA tensors only, launches
the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core import projections as proj
from . import _build

launches = 0   # wrapper calls that launched the kernel, since the last reset

MAX_LEVELS = 16      # lattice levels s..d the kernel takes
MAX_COMBOS = 1024    # combinations per level (m_max): d <= 12


@functools.lru_cache(maxsize=None)
def level_arrays(d: int, s: int, ratio: float):
    """The kernel's host arrays of the levels: M, lo and frac rounded once
    to float32 (as ``u < frac`` compares in float32)."""
    parts = proj.level_sample_parts(d, s, ratio)
    nums = (ctypes.c_int * len(parts))(*(m for m, _, _ in parts))
    los = (ctypes.c_int * len(parts))(*(lo for _, lo, _ in parts))
    fracs = (ctypes.c_float * len(parts))(*(float(np.float32(f)) for _, _, f in parts))
    return nums, los, fracs


def sample_weights(key: torch.Tensor, step: torch.Tensor | None, row_mask: torch.Tensor | None,
                   batch: int, d: int, s: int, ratio: float) -> torch.Tensor:
    """(B, L, m_max) int32 weights of every level s..d under ``key`` ((2,)
    int64 key data), or under ``fold_in(key, step)`` when ``step`` (an
    int32 scalar) is given; rows scaled by ``row_mask`` ((B,) int32)."""
    global launches
    parts = proj.level_sample_parts(d, s, ratio)
    L, m_max = len(parts), max(m for m, _, _ in parts)
    if L > MAX_LEVELS or m_max > MAX_COMBOS:
        raise ValueError(f"the sample_weights kernel takes up to {MAX_LEVELS} levels of "
                         f"{MAX_COMBOS} combinations; d={d}, s={s} has {L} levels of up "
                         f"to {m_max}")
    device = key.device
    _build.require_cuda("sample_weights", device)
    _build.require("key", key, torch.int64, (2,), device)
    if step is not None:
        _build.require("step", step, torch.int32, (), device)
    if row_mask is not None:
        _build.require("row_mask", row_mask, torch.int32, (batch,), device)
    out = torch.empty((batch, L, m_max), dtype=torch.int32, device=device)
    if batch == 0:
        return out
    nums, los, fracs = level_arrays(d, s, ratio)
    _build.launch("sample_weights", device, key.data_ptr(),
                  None if step is None else step.data_ptr(),
                  None if row_mask is None else row_mask.data_ptr(), out.data_ptr(),
                  nums, los, fracs, batch, L, m_max)
    launches += 1
    return out
