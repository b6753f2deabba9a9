"""Common layers: norms, MLP, embeddings, RoPE, and their init.

The JAX package's ``models/layers.py`` without its logical-axes plumbing
(``P``, ``split_tree``, ``add_leading_axis_name``), which exists only for
GSPMD sharding.  Parameters are plain dicts of tensors.  Init draws from a
``torch.Generator`` on the generator's device and places the result on
``device``; the numbers differ from ``jax.random``'s, so the tests carry
the JAX package's parameters over with ``convert.model_params_from_numpy``.
"""
from __future__ import annotations

import numpy as np
import torch


def dense_init(generator: torch.Generator, shape, *, scale=None, device) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut to [-2, 2], times ``scale``
    (default 1 / sqrt(fan_in)); float32.  On the ``meta`` device nothing is
    drawn: the leaf of an abstract parameter tree."""
    if torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=torch.float32, device="meta")
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    scale = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    v = torch.empty(tuple(shape), dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(v, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (v * scale).to(device)


def zeros_init(shape, *, device) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=torch.float32, device=device)


def ones_init(shape, *, device) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, *, device) -> torch.Tensor:
    return ones_init((d,), device=device)


def rmsnorm(scale, x, eps: float = 1e-5):
    """RMS norm computed in float32, cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale).to(dt)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def init_embedding(generator: torch.Generator, vocab: int, d: int, *, device) -> torch.Tensor:
    return dense_init(generator, (vocab, d), scale=1.0, device=device)


def embed(table, token_ids, tp=None):
    """Rows of ``table`` for ``token_ids``.  Under tensor parallelism
    (``tp``, a ``launch.tensor_parallel.TensorParallel``) ``table`` is
    the rank's block of the vocabulary, looked up vocab-parallel."""
    return table[token_ids] if tp is None else tp.embed(table, token_ids)


def mask_padded_vocab(lg, true_vocab: int):
    """Padded vocabulary ids never win: set their logits to the dtype's
    lowest value."""
    v = lg.shape[-1]
    if v == true_vocab:
        return lg
    col = torch.arange(v, device=lg.device)
    return torch.where(col >= true_vocab, torch.finfo(lg.dtype).min, lg)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    """(head_dim / 2,) float32 inverse frequencies, numpy as in the JAX
    package."""
    exponent = np.arange(0, head_dim, 2, dtype=np.float32) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (B, S) integers.  Rotates in float32
    and casts back to ``x``'s dtype."""
    hd = x.shape[-1]
    freqs = torch.from_numpy(rope_frequencies(hd, theta)).to(x.device)     # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs                 # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_mlp(generator: torch.Generator, d: int, ff: int, *, device) -> dict:
    return {
        "w_gate": dense_init(generator, (d, ff), device=device),
        "w_up": dense_init(generator, (d, ff), device=device),
        "w_down": dense_init(generator, (ff, d), device=device),
    }


def mlp(params, x, tp=None):
    """SwiGLU.  Under tensor parallelism (``tp``) the rank holds a block
    of the ``d_ff`` columns: ``w_gate`` and ``w_up`` column-parallel,
    ``w_down`` row-parallel, its partial output summed over the model
    group."""
    if tp is not None:
        x = tp.copy(x)
    h = torch.nn.functional.silu(torch.matmul(x, params["w_gate"]))
    h = h * torch.matmul(x, params["w_up"])
    out = torch.matmul(h, params["w_down"])
    return out if tp is None else tp.reduce(out)
