"""LR schedules: functions of the int32 step tensor, returning a float32
scalar tensor on the step's device.

The arithmetic is the JAX package's as XLA compiles it, on host float32
scalars: a division by a constant is a product with its float32
reciprocal, ``cos`` is the C library's ``cosf`` (``_libm``), and a
multiply-add is fused.  So the rates equal those of the JAX package's
compiled schedule bit for bit.  ``warmup_cosine`` reads the
step on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ._libm import cosf, recip


def _fma(a, b, c) -> np.float32:
    """float32 a * b + c rounded once: the float32 product is exact in
    float64."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _device(step):
    return step.device if isinstance(step, torch.Tensor) else None


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(step):
        s = np.float32(int(step))
        warm = s * recip(max(warmup_steps, 1))
        prog = np.float32(min(max((s - np.float32(warmup_steps))
                                  * recip(max(total_steps - warmup_steps, 1)),
                                  np.float32(0.0)), np.float32(1.0)))
        # XLA contracts final_frac + c * (1 + cos) into one fused multiply-add
        cos = _fma(np.float32((1 - final_frac) * 0.5),
                   np.float32(1.0) + cosf(np.float32(np.pi) * prog), np.float32(final_frac))
        lr = np.float32(peak_lr) * (warm if s < warmup_steps else cos)
        return torch.tensor(lr, dtype=torch.float32, device=_device(step))
    return fn


def constant(lr: float):
    def fn(step):
        return torch.full((), lr, dtype=torch.float32, device=_device(step))
    return fn
