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
  trick ``(bits >> 9) | 0x3F800000`` viewed as float32, minus 1;
* :func:`randint` -- ``jax.random.randint`` with int32 output, per-element
  bounds included.

A key is an int64 tensor of shape (2,) holding the two uint32 words (what
``jax.random.key_data`` returns).  A stack of keys (..., 2) stands for
``vmap`` over keys: every function then works per key and puts the key
axes first.  A single key is read on the host; stacked keys and draws live
on the requested device.  All arithmetic keeps uint32 values in int64 and
masks to 32 bits after every add, multiply and shift.
"""
from __future__ import annotations

import math

import torch

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return torch.bitwise_or(torch.bitwise_and(x << r, _MASK32), x >> (32 - r))


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """The threefry2x32 block cipher (20 rounds) on int64 tensors holding
    uint32 words.  Key words are Python ints or int64 tensors that
    broadcast against ``x1``/``x2`` (one key per element, as ``vmap`` over
    keys gives in JAX)."""
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


def _words(key: torch.Tensor, extra_dims: int):
    """The two key words of ``key`` (..., 2): Python ints for one key,
    else int64 tensors (...,) followed by ``extra_dims`` unit axes."""
    if key.ndim == 1:
        k1, k2 = (int(v) for v in key.tolist())
        return k1, k2
    index = (Ellipsis,) + (None,) * extra_dims
    return key[..., 0][index], key[..., 1][index]


def PRNGKey(seed: int) -> torch.Tensor:  # noqa: N802 -- mirrors jax.random.PRNGKey
    """Key data of ``jax.random.PRNGKey(seed)``: (0, seed mod 2^32)."""
    return torch.tensor([0, int(seed) & _MASK32], dtype=torch.int64)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` is taken mod 2^32 (uint32).

    One key and an int give one (2,) key.  Keys (..., 2) and/or a data
    tensor broadcast: the result is (broadcast shape, 2), each element
    ``fold_in(key_i, data_i)``."""
    if key.ndim == 1 and not isinstance(data, torch.Tensor):
        k1, k2 = _words(key, 0)
        x = torch.tensor([0, int(data) & _MASK32], dtype=torch.int64)
        y0, y1 = threefry2x32(k1, k2, x[:1], x[1:])
        return torch.cat([y0, y1])
    data = torch.bitwise_and(torch.as_tensor(data, dtype=torch.int64).to(key.device),
                             _MASK32)
    k1, k2 = key[..., 0], key[..., 1]
    k1, k2, data = torch.broadcast_tensors(k1, k2, data)
    y0, y1 = threefry2x32(k1, k2, torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def _iota_2x32(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    iota = torch.arange(n, dtype=torch.int64, device=device)
    return iota >> 32, torch.bitwise_and(iota, _MASK32)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable): (..., num, 2) key data for
    keys (..., 2)."""
    k1, k2 = _words(key, 1)
    hi, lo = _iota_2x32(num, key.device)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return torch.stack([b1, b2], dim=-1)


def _draw_device(key: torch.Tensor, device) -> torch.device:
    """``device``, or the key's own device when it is None."""
    return key.device if device is None else torch.device(device)


def random_bits(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """32 random bits per element (int64 in [0, 2^32)), ``jax.random.bits``
    with uint32.  Keys (..., 2) give (..., *shape), on ``device`` (None:
    the key's device)."""
    shape = tuple(shape)
    device = _draw_device(key, device)
    if key.ndim > 1:
        key = key.to(device)
    k1, k2 = _words(key, 1)
    hi, lo = _iota_2x32(math.prod(shape), device)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return torch.bitwise_xor(b1, b2).reshape(tuple(key.shape[:-1]) + shape)


# Elements of one key's draws computed at a time: the int64 words of a
# slice, not of a whole optimizer leaf (a billion elements), are live.
DRAW_CHUNK = 1 << 25


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    float_bits = torch.bitwise_or(bits >> 9, 0x3F800000).to(torch.int32)
    return float_bits.view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1), on ``device``
    (None: the key's device).  One key's draws are made DRAW_CHUNK
    elements at a time (each element's bits depend only on its index)."""
    shape = tuple(shape)
    n = math.prod(shape)
    if key.ndim > 1 or n <= DRAW_CHUNK:
        return _bits_to_unit(random_bits(key, shape, device))
    device = _draw_device(key, device)
    k1, k2 = _words(key, 1)
    out = torch.empty(n, dtype=torch.float32, device=device)
    for start in range(0, n, DRAW_CHUNK):
        iota = torch.arange(start, min(start + DRAW_CHUNK, n), dtype=torch.int64, device=device)
        b1, b2 = threefry2x32(k1, k2, iota >> 32, torch.bitwise_and(iota, _MASK32))
        out[start:start + iota.numel()] = _bits_to_unit(torch.bitwise_xor(b1, b2))
    return out.reshape(shape)


_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


def mul_u32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 for a, b in [0, 2^32), without int64 overflow."""
    lo = a * torch.bitwise_and(torch.as_tensor(b), 0xFFFF)
    hi = torch.bitwise_and(a * (torch.as_tensor(b) >> 16), 0xFFFF) << 16
    return torch.bitwise_and(lo + hi, _MASK32)


def randint(key: torch.Tensor, shape, minval, maxval, device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` with int32 output,
    bit for bit (jax 0.9, ``jax/_src/random.py:_randint``).

    The key splits in two; each half draws 32 bits per value (higher and
    lower word); ``span = maxval - minval`` as uint32, 1 where
    ``maxval <= minval``; the offset is
    ``(hi % span) * (2^32 mod span) + lo % span``, mod span, with JAX's
    uint32 wrap-around kept (``2^32 mod span`` itself is computed as
    ``(2^16 mod span)^2`` in uint32, which wraps to 0 for spans above
    2^16).  ``minval``/``maxval`` are ints or tensors that broadcast to
    the output, (..., *shape) for keys (..., 2); they must lie in the
    int32 range.  The arithmetic is int64 with 32-bit masks.  The draws
    land on ``device`` (None: the key's device)."""
    shape = tuple(shape)
    device = _draw_device(key, device)
    if key.ndim > 1:
        key = key.to(device)
    out_shape = tuple(key.shape[:-1]) + shape
    lo_b = torch.as_tensor(minval, dtype=torch.int64).to(device)
    hi_b = torch.as_tensor(maxval, dtype=torch.int64).to(device)
    for bound in (lo_b, hi_b):
        if bound.numel() and (int(bound.min()) < _INT32_MIN or int(bound.max()) > _INT32_MAX):
            raise ValueError("randint bounds must lie in the int32 range")
    minval, maxval = (torch.broadcast_to(b, out_shape) for b in (lo_b, hi_b))
    k1, k2 = split(key).unbind(dim=-2)
    higher = random_bits(k1, shape, device)
    lower = random_bits(k2, shape, device)
    span = torch.bitwise_and(maxval - minval, _MASK32)
    span = torch.where(maxval <= minval, torch.ones_like(span), span)
    multiplier = torch.remainder(torch.full_like(span, 1 << 16), span)
    multiplier = torch.remainder(torch.bitwise_and(multiplier * multiplier, _MASK32), span)
    offset = mul_u32(torch.remainder(higher, span), multiplier)
    offset = torch.bitwise_and(offset + torch.remainder(lower, span), _MASK32)
    offset = torch.remainder(offset, span)
    value = torch.bitwise_and(minval + offset, _MASK32)
    value = torch.where(value > _INT32_MAX, value - (1 << 32), value)
    return value.to(torch.int32)
