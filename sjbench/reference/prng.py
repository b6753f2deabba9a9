"""threefry2x32 as ``jax.random`` draws it (``jax_threefry_partitionable``),
written out on int64 tensors that hold uint32 words.

A frozen part of the benchmark's yardstick: the SJPC sampling and the
reservoir's acceptance and bootstrap draws are specified as this stream, so
the plain reference replays it.  A key is an int64 tensor (..., 2) of the
two uint32 words (``jax.random.key_data``).  Every add, multiply and shift
is masked back to 32 bits.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry(k1, k2, x1, x2):
    """The 20-round threefry2x32 block of key (k1, k2) on counters (x1,
    x2); keys and counters broadcast."""
    k3 = k1 ^ k2 ^ 0x1BD11BDA
    ks = (k1, k2, k3)
    a = (x1 + k1) & M32
    b = (x2 + k2) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & M32
        b = (b + ks[(i + 2) % 3] + i + 1) & M32
    return a, b


def key(seed: int, device=None) -> torch.Tensor:
    """``PRNGKey(seed)``: (0, seed mod 2^32)."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64, device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``fold_in`` of keys (..., 2) with ``data`` (an int or a tensor that
    broadcasts against the keys' leading shape)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=k.device) & M32
    k1, k2, data = torch.broadcast_tensors(k[..., 0], k[..., 1], data)
    y0, y1 = threefry(k1, k2, torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def split2(k: torch.Tensor):
    """``split(key, 2)`` of keys (..., 2): the two halves, each (..., 2)."""
    k1, k2 = k[..., 0:1], k[..., 1:2]
    cnt = torch.arange(2, dtype=torch.int64, device=k.device)
    y0, y1 = threefry(k1, k2, torch.zeros_like(cnt), cnt)
    both = torch.stack([y0, y1], dim=-1)            # (..., 2, 2)
    return both[..., 0, :], both[..., 1, :]


def bits(k: torch.Tensor, start: int, count: int) -> torch.Tensor:
    """Elements ``start .. start + count`` of ``random_bits(k, n)`` for
    keys (..., 2): (..., count) int64 in [0, 2^32).  The element index is
    the 64-bit counter (hi, lo)."""
    idx = torch.arange(start, start + count, dtype=torch.int64, device=k.device)
    lead = k.shape[:-1]
    k1 = k[..., 0].reshape(lead + (1,))
    k2 = k[..., 1].reshape(lead + (1,))
    y0, y1 = threefry(k1, k2, idx >> 32, idx & M32)
    return y0 ^ y1


def unit_float(b: torch.Tensor) -> torch.Tensor:
    """32 random bits -> float32 uniform in [0, 1) by the mantissa trick."""
    return (((b >> 9) | 0x3F800000).to(torch.int32)).view(torch.float32) - 1.0


def randint(k: torch.Tensor, count: int, lo, hi) -> torch.Tensor:
    """``jax.random.randint(k, (count,), lo, hi)`` (int32 output, jax 0.9)
    for keys (..., 2): bounds broadcast against (..., count).  Returned as
    int64 values in [lo, hi)."""
    kh, kl = split2(k)
    higher = bits(kh, 0, count)
    lower = bits(kl, 0, count)
    lo = torch.as_tensor(lo, dtype=torch.int64, device=k.device)
    hi = torch.as_tensor(hi, dtype=torch.int64, device=k.device)
    lo, hi = torch.broadcast_tensors(lo, hi, higher)[:2]
    span = (hi - lo) & M32
    span = torch.where(hi <= lo, torch.ones_like(span), span)
    mult = torch.remainder(torch.full_like(span, 1 << 16), span)
    mult = torch.remainder((mult * mult) & M32, span)
    hmod = torch.remainder(higher, span)
    prod = ((hmod * (mult & 0xFFFF)) + (((hmod * (mult >> 16)) & 0xFFFF) << 16)) & M32
    off = torch.remainder((prod + torch.remainder(lower, span)) & M32, span)
    v = (lo + off) & M32
    return torch.where(v > 0x7FFFFFFF, v - (1 << 32), v)
