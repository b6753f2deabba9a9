"""Int8 gradient compression with error feedback: per-block abs-max
scaling to int8 codes (the JAX package's ``optim/compression.py``).

    g_q, scales = compress_int8(g + err)
    err = (g + err) - decompress_int8(g_q, scales, g.shape)

Codes and scales equal the JAX package's bit for bit (its division by
127 is XLA's product with the float32 reciprocal).  ``compressed_mean``
is the int8 payload's mean over the ranks of a process group.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ._libm import recip

BLOCK = 256


def compress_int8(x):
    """x -> (codes (nblocks, BLOCK) int8, scales (nblocks, 1) float32)."""
    flat = torch.as_tensor(x).reshape(-1)
    flat = F.pad(flat, (0, (-flat.shape[0]) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scales = torch.clamp_min(blocks.abs().amax(dim=1, keepdim=True) * float(recip(127.0)),
                             1e-12)
    codes = torch.clamp(torch.round(blocks / scales), -127, 127).to(torch.int8)
    return codes, scales


def decompress_int8(codes, scales, shape):
    flat = (codes.to(torch.float32) * scales).reshape(-1)
    return flat[:math.prod(shape)].reshape(tuple(shape))


def compressed_mean(x, group=None):
    """The mean of ``x`` over the ranks of ``group`` (None: the default
    group) from an int8 payload: each rank quantizes locally, the codes
    are summed as int32 (exact) and the scales summed, and the mean is
    dequantized with the mean scale.  The scale mean makes this an
    upper-bound reconstruction; error feedback at the caller absorbs the
    difference."""
    x = torch.as_tensor(x)
    codes, scales = compress_int8(x)
    csum = codes.to(torch.int32)
    ssum = scales.clone()
    dist.all_reduce(csum, group=group)
    dist.all_reduce(ssum, group=group)
    n = torch.tensor(float(dist.get_world_size(group)), dtype=torch.float32, device=x.device)
    avg_scale = ssum / n
    flat = (csum.to(torch.float32) * avg_scale / n).reshape(-1)
    return flat[:x.numel()].reshape(x.shape)
