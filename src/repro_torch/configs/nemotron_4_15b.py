"""nemotron-4-15b — dense, squared-ReLU MLP (no gating).

[arXiv:2402.16819; unverified]
32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    source="[arXiv:2402.16819; unverified]",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    act="squared_relu",
    train_mode="usec",
    subquadratic=False,
)
