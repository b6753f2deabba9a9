"""Decoder layer blocks: attention mixer + dense FFN with pre-norm
residuals, and the per-layer decode step.

A layer's *spec* is ``(kind, moe)`` from ``config._layer_list``.  This
slice of the port runs dense attention layers, spec ``("A", False)``;
Mamba (``"M"``) and MoE layers raise ``NotImplementedError`` until their
slices (ROADMAP queue 1, item 12).
"""
from __future__ import annotations

import torch

from . import attention as attn
from .config import Dims
from .layers import init_mlp, init_rmsnorm, mlp, rmsnorm


def _require_dense(spec) -> None:
    if tuple(spec) != ("A", False):
        raise NotImplementedError(
            f"layer spec {spec}: the port runs dense attention layers only; Mamba and "
            f"MoE layers come with their slices (ROADMAP queue 1, item 12)")


def init_layer(generator: torch.Generator, dims: Dims, spec, *, device) -> dict:
    _require_dense(spec)
    cfg = dims.cfg
    p = {"mixer_norm": init_rmsnorm(cfg.d_model, device=device),
         "attn": attn.init_attention(generator, dims, device=device)}
    if cfg.d_ff > 0:
        p["mlp_norm"] = init_rmsnorm(cfg.d_model, device=device)
        p["mlp"] = init_mlp(generator, cfg.d_model, cfg.dense_ff or cfg.d_ff, device=device)
    return p


def _ffn(params, x, dims: Dims):
    if "mlp" in params:
        return x + mlp(params["mlp"], rmsnorm(params["mlp_norm"], x, dims.cfg.rms_eps))
    return x


def apply_layer(params, x, dims: Dims, spec, *, positions, causal=True,
                attn_chunk: int = 2048, impl: str | None = None):
    """Full-sequence layer (prefill).  Returns (x, cache_out), cache_out
    holding this pass's attention K/V."""
    _require_dense(spec)
    h = rmsnorm(params["mixer_norm"], x, dims.cfg.rms_eps)
    out, (k, v) = attn.attention_block(params["attn"], h, dims, positions, causal=causal,
                                       chunk=attn_chunk, impl=impl)
    x = _ffn(params, x + out, dims)
    return x, {"k": k, "v": v}


def decode_layer(params, x, dims: Dims, spec, cache, lens):
    """One-token layer step.  x (B,1,d); cache is this layer's state dict,
    updated in place.  Returns (x, cache)."""
    _require_dense(spec)
    h = rmsnorm(params["mixer_norm"], x, dims.cfg.rms_eps)
    out, ck, cv = attn.decode_attention_block(params["attn"], h, dims, cache["k"],
                                              cache["v"], lens)
    x = _ffn(params, x + out, dims)
    return x, dict(cache, k=ck, v=cv)


def init_layer_cache(dims: Dims, spec, batch: int, max_len: int, *, stack: tuple = (),
                     dtype=torch.bfloat16, device) -> dict:
    """Zero decode cache for one layer, or for ``stack`` layers of it."""
    _require_dense(spec)
    shape = tuple(stack) + (batch, max_len, dims.kv_heads, dims.cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
