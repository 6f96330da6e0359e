"""glm4-9b — dense, aggressive GQA (kv=2), RoPE.

[hf:THUDM/glm-4-9b; hf]
40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    source="[hf:THUDM/glm-4-9b; hf]",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151552,
    act="swiglu",
    train_mode="usec",
    subquadratic=False,
)
