"""hubert-xlarge — encoder-only audio transformer (w2v2 arch).

[arXiv:2106.07447; unverified]
48L d_model=1280 16H (MHA kv=16) d_ff=5120 vocab=504 (masked-unit targets).
The conv waveform frontend is a STUB: input_specs() supplies precomputed
frame embeddings (dim 512, the conv feature dim); a linear adapter projects
to d_model. No decode path (encoder-only) -> decode cells skip.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="encoder",
    source="[arXiv:2106.07447; unverified]",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    act="gelu",
    norm="layernorm",
    decoder=False,
    frontend="audio_frames",
    frontend_dim=512,
    train_mode="dp",
    subquadratic=False,
)
