"""Qwen2-7B.  [arXiv:2407.10671; hf] -- GQA kv=4, QKV bias.

28 query heads pad to 32 for TP=16.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
