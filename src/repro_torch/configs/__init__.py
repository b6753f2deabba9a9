"""Configurations the port supports: the SJPC paper defaults
(``sjpc_paper``) and the architectures of the LM stack.

``get(name)`` returns the full ``ArchConfig``; ``reduced(name)`` a
CPU-test-sized config of the same family (same layer pattern, MoE
structure, GQA ratio -- tiny dims), field for field the JAX package's.
The registry holds the dense architecture the port serves; the MoE, SSM
and encoder-decoder ones come with their slices (ROADMAP queue 1).
"""
from __future__ import annotations

from repro_torch.models.config import ArchConfig

from .qwen2_5_3b import CONFIG as qwen2_5_3b

REGISTRY: dict[str, ArchConfig] = {c.name: c for c in [qwen2_5_3b]}


def get(name: str) -> ArchConfig:
    return REGISTRY[name]


# ---------------------------------------------------------------------------
# Reduced smoke configs (CPU tests): same family shape, tiny dims
# ---------------------------------------------------------------------------

def reduced(name: str) -> ArchConfig:
    cfg = REGISTRY[name]
    period = cfg.period
    layers = max(2 * period, 2)
    # keep one full period (+ leading dense layer if any)
    if cfg.leading_dense_layers:
        layers = period + cfg.leading_dense_layers
    kw = dict(
        name=cfg.name + "-smoke",
        family=cfg.family,
        num_layers=layers,
        d_model=64,
        num_heads=0 if cfg.attention_free else 4,
        num_kv_heads=0 if cfg.attention_free else max(1, 4 * cfg.num_kv_heads // max(cfg.num_heads, 1)),
        d_ff=0 if cfg.d_ff == 0 else 128,
        dense_ff=0 if cfg.dense_ff == 0 else 160,
        vocab_size=256,
        head_dim=16,
        num_experts=min(cfg.num_experts, 8),
        num_experts_per_tok=min(cfg.num_experts_per_tok, 2),
        num_shared_experts=min(cfg.num_shared_experts, 1),
        # drop-free capacity in smoke configs: keeps batched dispatch ==
        # per-token decode dispatch (capacity drops are exercised in
        # tests/test_moe_dispatch.py instead)
        capacity_factor=float(min(cfg.num_experts, 8)) if cfg.num_experts else 1.25,
        moe_period=cfg.moe_period,
        moe_offset=cfg.moe_offset,
        leading_dense_layers=cfg.leading_dense_layers,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_conv=cfg.ssm_conv,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_expand=cfg.ssm_expand,
        ssm_groups=cfg.ssm_groups,
        layer_pattern=cfg.layer_pattern,
        encoder_layers=2 if cfg.is_encdec else 0,
        qkv_bias=cfg.qkv_bias,
        tie_embeddings=cfg.tie_embeddings,
        frontend=cfg.frontend,
    )
    return ArchConfig(**kw)
