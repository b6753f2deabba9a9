"""Decoder and encoder layer blocks: mixer (attention | mamba) and FFN
(dense | MoE) with pre-norm residuals, an optional cross-attention
sub-block (encoder-decoder), and the per-layer decode step.

A layer's *spec* is ``(kind, moe)`` with kind in {'A', 'M'}, from
``config._layer_list``; specs drive both init (the parameter structure)
and apply, as in the JAX package's ``models/blocks.py``.

``tp`` (a ``launch.tensor_parallel.TensorParallel``) runs a layer on the
rank's block of the model axis (heads, ``d_ff`` columns, experts, SSM
heads); ``dp`` (a ``launch.data_parallel.DataParallel``) is the batch
axes': the MoE layers' routing groups across its ranks, and at decode a
sequence-sharded cache.  None: one process.
"""
from __future__ import annotations

import functools

import torch

from . import attention as attn
from . import ssm
from .config import Dims
from .layers import init_mlp, init_rmsnorm, mlp, rmsnorm
from .moe import init_moe, moe_ffn


def init_layer(generator: torch.Generator, dims: Dims, spec, *, cross: bool = False,
               device) -> dict:
    kind, moe = spec
    cfg = dims.cfg
    p = {"mixer_norm": init_rmsnorm(cfg.d_model, device=device)}
    if kind == "A":
        p["attn"] = attn.init_attention(generator, dims, device=device)
    else:
        p["mamba"] = ssm.init_mamba(generator, dims, device=device)
    if cross:
        p["cross_norm"] = init_rmsnorm(cfg.d_model, device=device)
        p["cross"] = attn.init_attention(generator, dims, cross=True, device=device)
    if cfg.d_ff > 0:
        p["mlp_norm"] = init_rmsnorm(cfg.d_model, device=device)
        if moe:
            p["moe"] = init_moe(generator, cfg.d_model, cfg.d_ff, cfg.num_experts,
                                cfg.num_shared_experts, device=device)
        else:
            p["mlp"] = init_mlp(generator, cfg.d_model, cfg.dense_ff or cfg.d_ff,
                                device=device)
    return p


def _ffn(params, x, dims: Dims, aux, dp=None, tp=None):
    """The FFN sub-block; MoE layers add their aux losses into ``aux``
    (when it is not None).  Under data parallelism (``dp``) an MoE layer
    routes the global batch's groups; ``tp``: the rank's experts or
    ``d_ff`` columns.  Returns (x, aux)."""
    cfg = dims.cfg
    if "moe" in params:
        fn = functools.partial(moe_ffn, params["moe"], num_experts=cfg.num_experts,
                               top_k=cfg.num_experts_per_tok,
                               capacity_factor=cfg.capacity_factor, tp=tp)
        h = rmsnorm(params["mlp_norm"], x, cfg.rms_eps)
        h, moe_aux = fn(h) if dp is None else dp.moe(fn, h, 1 if tp is None else tp.seq_shards)
        if aux is not None:
            aux = {k: aux.get(k, 0.0) + v for k, v in moe_aux.items()}
        return x + h, aux
    if "mlp" in params:
        return x + mlp(params["mlp"], rmsnorm(params["mlp_norm"], x, cfg.rms_eps), tp), aux
    return x, aux


def apply_layer(params, x, dims: Dims, spec, *, positions, causal=True, enc_mem=None,
                aux=None, ssm_chunk: int = ssm.DEFAULT_CHUNK, attn_chunk: int = 2048,
                probs_dtype=torch.float32, impl: str | None = None, dp=None, tp=None,
                final_state: bool = True):
    """Full-sequence layer (train / prefill).  Returns (x, cache_out, aux).

    cache_out carries whatever decode needs: this pass's attention K/V,
    the mamba final states (the SSM state None without ``final_state``:
    a training forward has no use for it), the cross-attention memory K/V.
    ``probs_dtype`` is the attention probabilities' type (the softmax
    itself is float32); ``impl`` names the flash-attention op's
    implementation (None: by device); ``dp`` is a data-parallel step's
    ``launch.data_parallel.DataParallel`` (None: one process); ``tp``
    the rank's block of the model axis.
    """
    kind, _ = spec
    cfg = dims.cfg
    cache_out = {}
    h = rmsnorm(params["mixer_norm"], x, cfg.rms_eps)
    if kind == "A":
        out, (k, v) = attn.attention_block(params["attn"], h, dims, positions, causal=causal,
                                           chunk=attn_chunk, probs_dtype=probs_dtype,
                                           impl=impl, tp=tp)
        cache_out["k"], cache_out["v"] = k, v
    else:
        out, states = ssm.mamba_block(params["mamba"], h, dims, chunk=ssm_chunk, tp=tp,
                                      final_state=final_state)
        cache_out["mamba"] = states
    x = x + out
    if "cross" in params:
        h = rmsnorm(params["cross_norm"], x, cfg.rms_eps)
        out, (mk, mv) = attn.attention_block(params["cross"], h, dims, positions,
                                             causal=False, kv_override=enc_mem,
                                             chunk=attn_chunk, probs_dtype=probs_dtype,
                                             impl=impl, tp=tp)
        cache_out["mk"], cache_out["mv"] = mk, mv
        x = x + out
    x, aux = _ffn(params, x, dims, aux, dp, tp)
    return x, cache_out, aux


def decode_layer(params, x, dims: Dims, spec, cache, lens, *, tp=None, dp=None):
    """One-token layer step.  x (B,1,d); cache is this layer's state dict,
    updated in place (K/V rows, mamba conv and SSM states).  ``tp`` and
    ``dp`` as for :func:`apply_layer` (``dp`` with ``seq_sharded``: the
    cache holds this rank's block of the positions).  Returns (x, cache)."""
    kind, _ = spec
    cfg = dims.cfg
    h = rmsnorm(params["mixer_norm"], x, cfg.rms_eps)
    if kind == "A":
        out, _, _ = attn.decode_attention_block(params["attn"], h, dims, cache["k"],
                                                cache["v"], lens, tp=tp, dp=dp)
    else:
        state = cache["mamba"]
        out, new = ssm.mamba_decode_step(params["mamba"], h, dims, state["conv"],
                                         state["ssm"], tp=tp)
        for name in ("x", "bc"):
            state["conv"][name].copy_(new["conv"][name])
        state["ssm"].copy_(new["ssm"])
    x = x + out
    if "cross" in params:
        h = rmsnorm(params["cross_norm"], x, cfg.rms_eps)
        x = x + attn.decode_cross_attention_block(params["cross"], h, dims, cache["mk"],
                                                  cache["mv"], tp=tp, dp=dp)
    x, _ = _ffn(params, x, dims, None, dp, tp)
    return x, cache


def init_layer_cache(dims: Dims, spec, batch: int, max_len: int, src_len: int = 0, *,
                     stack: tuple = (), dtype=torch.bfloat16, device,
                     tp_size: int = 1) -> dict:
    """Zero decode cache for one layer, or for ``stack`` layers of it.
    ``batch``, ``max_len`` and ``src_len`` are the rank's rows and
    positions; a rank of a model axis of ``tp_size`` holds KV / tp_size
    heads and H / tp_size SSM heads."""
    kind, _ = spec
    cfg = dims.cfg
    c = {}
    lead, heads = tuple(stack) + (batch,), (dims.kv_heads // tp_size, cfg.head_dim)
    if kind == "A":
        c["k"] = torch.zeros(lead + (max_len,) + heads, dtype=dtype, device=device)
        c["v"] = torch.zeros(lead + (max_len,) + heads, dtype=dtype, device=device)
    else:
        c["mamba"] = ssm.init_mamba_state(dims, batch, dtype, stack=stack, device=device,
                                          tp_size=tp_size)
    if cfg.is_encdec and src_len > 0:
        c["mk"] = torch.zeros(lead + (src_len,) + heads, dtype=dtype, device=device)
        c["mv"] = torch.zeros(lead + (src_len,) + heads, dtype=dtype, device=device)
    return c
