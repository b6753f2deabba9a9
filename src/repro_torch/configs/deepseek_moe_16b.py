"""DeepSeek-MoE 16B.  [arXiv:2401.06066; hf]

2 shared + 64 routed experts (top-6), fine-grained (expert d_ff=1408);
first layer is a dense MLP (d_ff 10944); MHA (kv == heads == 16).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    dense_ff=10944,
    vocab_size=102400,
    head_dim=128,
    num_experts=64,
    num_experts_per_tok=6,
    num_shared_experts=2,
    leading_dense_layers=1,
    rope_theta=10_000.0,
)
