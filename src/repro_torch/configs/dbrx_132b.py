"""DBRX (132B total).  [hf:databricks/dbrx-base; unverified]

16 experts top-4 fine-grained MoE on every layer, GQA kv=8.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    head_dim=128,
    num_experts=16,
    num_experts_per_tok=4,
    rope_theta=500_000.0,
)
