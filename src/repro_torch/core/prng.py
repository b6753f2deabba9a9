"""Replay of ``jax.random``'s threefry2x32 stream on int64 tensors.

The SJPC sampling keys of the JAX package come from ``jax.random`` with
``jax_threefry_partitionable=True`` (the default of jax 0.9).  This module
recomputes the same key data and draws, bit for bit, so the port samples
the same projections as the reference under the default keys:

* :func:`PRNGKey` -- ``threefry_seed``: the key of an integer seed is
  (0, seed mod 2^32) when JAX runs in 32-bit mode;
* :func:`fold_in` -- ``threefry_2x32(key, [0, data])``;
* :func:`split` -- the fold-like split: threefry of the 64-bit iota split
  into (hi, lo) words, keys stacked as (bits1, bits2);
* :func:`uniform` -- 32 random bits ``bits1 ^ bits2``, then the mantissa
  trick ``(bits >> 9) | 0x3F800000`` viewed as float32, minus 1.

A key is an int64 tensor of shape (2,) holding the two uint32 words (what
``jax.random.key_data`` returns).  Keys are derived on the CPU; draws are
made on the requested device.  All arithmetic keeps uint32 values in int64
and masks to 32 bits after every add and shift.
"""
from __future__ import annotations

import math

import torch

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return torch.bitwise_or(torch.bitwise_and(x << r, _MASK32), x >> (32 - r))


def threefry2x32(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor):
    """The threefry2x32 block cipher (20 rounds) on int64 tensors holding
    uint32 words; key words are Python ints."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = torch.bitwise_and(x1 + ks[0], _MASK32)
    x1 = torch.bitwise_and(x2 + ks[1], _MASK32)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = torch.bitwise_and(x0 + x1, _MASK32)
            x1 = torch.bitwise_xor(_rotl(x1, r), x0)
        x0 = torch.bitwise_and(x0 + ks[(i + 1) % 3], _MASK32)
        x1 = torch.bitwise_and(x1 + ks[(i + 2) % 3] + i + 1, _MASK32)
    return x0, x1


def _words(key: torch.Tensor) -> tuple[int, int]:
    k1, k2 = (int(v) for v in key.tolist())
    return k1, k2


def PRNGKey(seed: int) -> torch.Tensor:  # noqa: N802 -- mirrors jax.random.PRNGKey
    """Key data of ``jax.random.PRNGKey(seed)``: (0, seed mod 2^32)."""
    return torch.tensor([0, int(seed) & _MASK32], dtype=torch.int64)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` is taken mod 2^32 (uint32)."""
    k1, k2 = _words(key)
    x = torch.tensor([0, int(data) & _MASK32], dtype=torch.int64)
    y0, y1 = threefry2x32(k1, k2, x[:1], x[1:])
    return torch.cat([y0, y1])


def _iota_2x32(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    iota = torch.arange(n, dtype=torch.int64, device=device)
    return iota >> 32, torch.bitwise_and(iota, _MASK32)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable): (num, 2) key data."""
    k1, k2 = _words(key)
    hi, lo = _iota_2x32(num, "cpu")
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return torch.stack([b1, b2], dim=1)


def random_bits(key: torch.Tensor, shape, device="cpu") -> torch.Tensor:
    """32 random bits per element (int64 in [0, 2^32))."""
    k1, k2 = _words(key)
    hi, lo = _iota_2x32(math.prod(shape), device)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return torch.bitwise_xor(b1, b2).reshape(shape)


def uniform(key: torch.Tensor, shape, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1)."""
    bits = random_bits(key, shape, device)
    float_bits = torch.bitwise_or(bits >> 9, 0x3F800000).to(torch.int32)
    return float_bits.view(torch.float32) - 1.0
