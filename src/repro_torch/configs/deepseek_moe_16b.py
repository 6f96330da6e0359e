"""deepseek-moe-16b — fine-grained MoE, 2 shared + 64 routed top-6.

[arXiv:2401.06066; hf:deepseek-ai/deepseek-moe-16b-base]
28L d_model=2048 16H (MHA: kv=16) expert d_ff=1408 vocab=102400.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    source="[arXiv:2401.06066; hf]",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    act="swiglu",
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    train_mode="usec",
    subquadratic=False,
)
