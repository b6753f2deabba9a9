"""Configurations the port supports: the SJPC paper defaults
(``sjpc_paper``) and the ten architectures of the LM stack (public-literature
specs, verbatim, as in the JAX package's ``configs/``), with the input-shape
pool.

``get(name)`` returns the full ``ArchConfig``; ``reduced(name)`` a
CPU-test-sized config of the same family (same layer pattern, MoE
structure, GQA ratio -- tiny dims), field for field the JAX package's.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ArchConfig

from .chameleon_34b import CONFIG as chameleon_34b
from .dbrx_132b import CONFIG as dbrx_132b
from .deepseek_coder_33b import CONFIG as deepseek_coder_33b
from .deepseek_moe_16b import CONFIG as deepseek_moe_16b
from .internlm2_20b import CONFIG as internlm2_20b
from .jamba_1_5_large_398b import CONFIG as jamba_1_5_large_398b
from .mamba2_370m import CONFIG as mamba2_370m
from .qwen2_5_3b import CONFIG as qwen2_5_3b
from .qwen2_7b import CONFIG as qwen2_7b
from .seamless_m4t_large_v2 import CONFIG as seamless_m4t_large_v2

REGISTRY: dict[str, ArchConfig] = {
    c.name: c for c in [
        jamba_1_5_large_398b, dbrx_132b, deepseek_moe_16b,
        seamless_m4t_large_v2, internlm2_20b, deepseek_coder_33b,
        qwen2_7b, qwen2_5_3b, chameleon_34b, mamba2_370m,
    ]
}

ARCH_NAMES = list(REGISTRY)


def get(name: str) -> ArchConfig:
    return REGISTRY[name]


# ---------------------------------------------------------------------------
# Input shapes (assigned pool): every cell = (arch x shape)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq: int           # sequence length (cache length for decode)
    batch: int         # global batch


SHAPES = {
    "train_4k":    ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k":   ShapeSpec("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: ArchConfig, shape: str) -> bool:
    """long_500k needs a sub-quadratic path (SSM/hybrid only)."""
    if shape == "long_500k":
        return cfg.supports_long_context()
    return True


def cells(arch_names=None) -> list[tuple[str, str]]:
    """All runnable (arch, shape) cells."""
    names = arch_names or ARCH_NAMES
    out = []
    for a in names:
        for s in SHAPES:
            if applicable(REGISTRY[a], s):
                out.append((a, s))
    return out


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
