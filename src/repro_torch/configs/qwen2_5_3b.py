"""Qwen2.5-3B.  [hf:Qwen/Qwen2.5-3B; hf] -- GQA kv=2, QKV bias, tied embed."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)
