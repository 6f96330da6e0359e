"""recurrentgemma-2b — Griffin hybrid: RG-LRU + local attention, 1:2.

[arXiv:2402.19427; hf:google/recurrentgemma-2b]
26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000, window 2048,
pattern (rglru, rglru, lattn) x 8 + 2 trailing recurrent layers.
Sub-quadratic -> the long_500k decode cell RUNS for this arch.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    source="[arXiv:2402.19427; hf]",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    act="geglu",
    layer_pattern=("rglru", "rglru", "lattn"),
    window=2048,
    rglru_expand=1,
    train_mode="usec",
    subquadratic=True,
    tie_embeddings=True,
)
