"""mamba2-370m — attention-free SSD (state-space duality).

[arXiv:2405.21060; unverified]
48L d_model=1024, ssm_state=128, headdim 64, expand 2 (d_inner 2048, 32 heads),
vocab 50280. Constant-state decode -> long_500k RUNS.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    source="[arXiv:2405.21060; unverified]",
    n_layers=48,
    d_model=1024,
    n_heads=1,
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    layer_pattern=("ssm",),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    train_mode="dp",
    subquadratic=True,
    tie_embeddings=True,
)
