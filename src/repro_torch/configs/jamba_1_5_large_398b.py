"""Jamba-1.5-Large (398B).  [arXiv:2403.19887 / 2408.12570; hf]

Mamba+attention 1:7 interleave (attention at position 4 of each 8-layer
period, matching attn_layer_period=8 / attn_layer_offset=4), MoE 16e top-2
on every other layer (expert_layer_period=2, offset=1).  The Mamba mixers
are modeled with the SSD (Mamba2) formulation -- state 64, head 64 --
DESIGN.md §8 records this adaptation.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    num_experts=16,
    num_experts_per_tok=2,
    moe_period=2,
    moe_offset=1,
    layer_pattern="MMMMAMMM",
    ssm_state=64,
    ssm_conv=4,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=8,
    rope_theta=1_000_000.0,
)
