"""DeepSeek-Coder-33B.  [arXiv:2401.14196; hf] -- llama-arch, GQA kv=8.

56 query heads pad to 64 for TP=16 (zero-init pad heads; waste reported in
the roofline MODEL_FLOPS/HLO ratio).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    head_dim=128,
    rope_theta=100_000.0,
)
