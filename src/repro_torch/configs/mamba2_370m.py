"""Mamba2-370M.  [arXiv:2405.21060; unverified]

Attention-free SSD: 48 layers, d_model 1024, expand 2 (d_inner 2048),
head 64 (32 heads), state 128.  No FFN (d_ff = 0).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_conv=4,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
)
