"""SeamlessM4T-large v2 text backbone.  [arXiv:2308.11596; hf]

Encoder-decoder, 24+24 layers; the speech/text modality frontend is a stub
(input_specs supplies precomputed frame embeddings (B, S_src, d_model)).
MHA (16 heads, head_dim 64).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    head_dim=64,
    frontend="audio",
    rope_theta=10_000.0,
)
