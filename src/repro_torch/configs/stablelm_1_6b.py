"""stablelm-1.6b — small dense decoder.

[hf:stabilityai/stablelm-2-1_6b; unverified]
24L d_model=2048 32H (MHA kv=32) d_ff=5632 vocab=100352.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    source="[hf:stabilityai/stablelm-2-1_6b; unverified]",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab_size=100352,
    act="swiglu",
    train_mode="dp",
    grad_accum_dtype="bfloat16",
    attn_chunk=4096,
    subquadratic=False,
)
