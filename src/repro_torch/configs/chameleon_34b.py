"""Chameleon-34B.  [arXiv:2405.09818; unverified]

Early-fusion VLM: VQ image tokens are ordinary vocabulary ids, so the
backbone is a plain dense decoder; the image tokenizer is a frontend stub.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    head_dim=128,
    frontend="vision",
    rope_theta=10_000.0,
)
