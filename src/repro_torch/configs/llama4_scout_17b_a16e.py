"""llama4-scout-17b-a16e — MoE 16e top-1, early fusion.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, 16 experts top-1 plus
one shared expert per layer (Scout interleaves MoE on every layer).
"early fusion" refers to its native multimodal training; the LM trunk built
here is the text path (the modality frontend pattern is exercised by
internvl2-2b). Total params ~109B -> fsdp train mode (see DESIGN §6).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    source="[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    act="swiglu",
    n_experts=16,
    top_k=1,
    n_shared_experts=1,
    moe_d_ff=8192,
    train_mode="fsdp",
    subquadratic=False,
)
