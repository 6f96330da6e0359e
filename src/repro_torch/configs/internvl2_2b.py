"""internvl2-2b — VLM: InternViT frontend (stubbed) + InternLM2-1.8B trunk.

[arXiv:2404.16821; hf:OpenGVLab/InternVL2-2B]
24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
The ViT is a STUB: input_specs() supplies precomputed patch embeddings
(dim 1024 = InternViT-300M hidden); a linear adapter projects to d_model and
the patches are prepended to the text tokens (loss on text only).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    source="[arXiv:2404.16821; hf]",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    act="swiglu",
    frontend="vision_patches",
    frontend_dim=1024,
    prefix_len=1024,
    train_mode="dp",
    grad_accum_dtype="bfloat16",
    attn_chunk=4096,
    subquadratic=False,
)
