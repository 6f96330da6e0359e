"""qwen1.5-110b — the largest assigned dense arch; QKV bias.

[hf:Qwen/Qwen1.5-110B (dims per assignment); hf]
80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.
~111B params -> fsdp train mode with microbatched grad accumulation and
chunked cross-entropy (the (B,S,V) logits tensor would be ~PB otherwise).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    source="[hf:Qwen/Qwen1.5-110B; hf]",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab_size=152064,
    act="swiglu",
    qkv_bias=True,
    train_mode="fsdp",
    subquadratic=False,
)
