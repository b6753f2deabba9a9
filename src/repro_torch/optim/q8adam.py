"""Q8Adam: AdamW with block-wise int8 moments and stochastic rounding.

The JAX package's ``optim/q8adam.py``.  Both moments are stored as int8
codes with one float32 scale per block of 256 elements (~2.03 B per
parameter against AdamW's 8): the first moment on a linear symmetric map,
the second on the quartic map ``q = 255 * (v / max) ** (1/4)`` stored as
``q - 128``.  Stochastic rounding draws ``jax.random.uniform`` of
``fold_in(fold_in(PRNGKey(seed), step), 2*i)`` (and ``2*i + 1`` for the
second moment) of leaf ``i`` in ``jax.tree_util``'s order, replayed by
:mod:`..core.prng`, so the draws are JAX's own.

How the numbers compare with the JAX package's: ``quantize``,
``dequantize`` and ``dequantize_v`` equal them bit for bit (a division
by a constant is XLA's product with the float32 reciprocal, and
``dequantize_v`` looks up the 256 values of ``t ** 4`` that the C
library's ``powf``, XLA's CPU ``pow``, gives).  ``quantize_v`` takes the
fourth root as two float64 square roots rounded to float32, which is
within a float32 ulp of ``powf``: a code can differ only where that ulp
crosses an integer of ``255 * t`` (+ the draw).

Parameters are updated in place, as ``make_adamw``'s are; the moments
come back as new ``QTensor``s.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import prng
from ..tree import tree_flatten, tree_map
from ._libm import powf, recip
from .adamw import Optimizer, _clip_in_place, _scalars, bias_corrections

BLOCK = 256
V_POWER = 4.0


class QTensor(NamedTuple):
    codes: torch.Tensor       # (nblocks, BLOCK) int8
    scales: torch.Tensor      # (nblocks, 1) float32


class Q8State(NamedTuple):
    step: torch.Tensor
    m: dict
    v: dict


def _blocks(x, nonneg: bool = False) -> torch.Tensor:
    flat = torch.as_tensor(x).reshape(-1).to(torch.float32)
    if nonneg:
        flat = torch.clamp_min(flat, 0.0)
    return F.pad(flat, (0, (-flat.shape[0]) % BLOCK)).reshape(-1, BLOCK)


def _round(q: torch.Tensor, key) -> torch.Tensor:
    """Stochastic rounding with ``key`` ((2,) key data), else nearest."""
    if key is None:
        return torch.round(q)
    return torch.floor(q + prng.uniform(key, q.shape, device=q.device))


def _unpad(flat: torch.Tensor, shape) -> torch.Tensor:
    return flat[:math.prod(shape)].reshape(tuple(shape))


def quantize(x, key=None) -> QTensor:
    """float32 tensor -> QTensor on the linear symmetric map (the first
    moment); stochastic rounding when ``key`` is given."""
    blocks = _blocks(x)
    scales = torch.clamp_min(blocks.abs().amax(dim=1, keepdim=True) * float(recip(127.0)),
                             1e-12)
    q = _round(blocks / scales, key)
    return QTensor(codes=torch.clamp(q, -127, 127).to(torch.int8), scales=scales)


def dequantize(qt: QTensor, shape) -> torch.Tensor:
    return _unpad((qt.codes.to(torch.float32) * qt.scales).reshape(-1), shape)


def quantize_v(x, key=None) -> QTensor:
    """Nonnegative tensor -> QTensor on the quartic map (the second
    moment)."""
    blocks = _blocks(x, nonneg=True)
    scales = torch.clamp_min(blocks.amax(dim=1, keepdim=True), 1e-30)
    root = torch.sqrt(torch.sqrt((blocks / scales).to(torch.float64))).to(torch.float32)
    t = _round(root * 255.0, key)
    return QTensor(codes=(torch.clamp(t, 0, 255) - 128.0).to(torch.int8), scales=scales)


@functools.lru_cache(maxsize=None)
def _quartic_table(device: torch.device) -> torch.Tensor:
    """``((c + 128) / 255) ** 4`` for the 256 codes, as XLA's CPU ``pow``
    (the C library's ``powf``) gives it, on ``device``."""
    values = [powf(np.float32(i) * recip(255.0), V_POWER) for i in range(256)]
    return torch.tensor(np.array(values, dtype=np.float32), device=device)


def dequantize_v(qt: QTensor, shape) -> torch.Tensor:
    t4 = _quartic_table(qt.codes.device)[qt.codes.to(torch.int64) + 128]
    return _unpad((qt.scales * t4).reshape(-1), shape)


def make_q8adam(lr_fn, *, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                weight_decay: float = 0.1, clip_norm: float = 1.0,
                seed: int = 17) -> Optimizer:

    def init(params):
        leaves, _ = tree_flatten(params)
        device = leaves[0].device if leaves else None
        qm = lambda p: quantize(torch.zeros(p.shape, dtype=torch.float32, device=p.device))
        qv = lambda p: quantize_v(torch.zeros(p.shape, dtype=torch.float32, device=p.device))
        return Q8State(step=torch.zeros((), dtype=torch.int32, device=device),
                       m=tree_map(qm, params), v=tree_map(qv, params))

    @torch.no_grad()
    def update(grads, state: Q8State, params):
        leaves, treedef = tree_flatten(params)
        gl = [g.to(torch.float32).contiguous() for g in treedef.flatten_up_to(grads)]
        ml = treedef.flatten_up_to(state.m)
        vl = treedef.flatten_up_to(state.v)
        gnorm = _clip_in_place(gl, clip_norm, leaves)
        step = state.step + 1
        lr = lr_fn(step).to(step.device)
        n = int(step)
        bc1, bc2 = _scalars(step.device, *bias_corrections(n, b1, b2))
        base = prng.fold_in(prng.PRNGKey(seed), n)
        new_m, new_v = [], []
        for i, (p, g, mq, vq) in enumerate(zip(leaves, gl, ml, vl)):
            m = dequantize(mq, p.shape) * b1 + g * (1 - b1)
            v = dequantize_v(vq, p.shape) * b2 + g * (1 - b2) * g
            delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if p.ndim > 1:
                delta = delta + p.to(torch.float32) * weight_decay
            p.sub_((delta * lr).to(p.dtype))
            new_m.append(quantize(m, prng.fold_in(base, 2 * i)))
            new_v.append(quantize_v(v, prng.fold_in(base, 2 * i + 1)))
        return (params, Q8State(step, treedef.unflatten(new_m), treedef.unflatten(new_v)),
                {"grad_norm": gnorm, "lr": lr})

    return Optimizer(init=init, update=update)
