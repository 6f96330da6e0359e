"""Architecture config schema.

One :class:`ArchConfig` per assigned architecture (see ``configs/<id>.py``)
plus the paper's own setup (``usec_paper.py``). Every field that shapes the
compiled program is explicit — nothing is inferred from strings at trace time.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class ArchConfig:
    # ---- identity -------------------------------------------------- #
    name: str
    family: str            # dense | moe | ssm | hybrid | encoder | vlm
    source: str = ""       # provenance note ([hf:...] / [arXiv:...])

    # ---- trunk ----------------------------------------------------- #
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    head_dim: Optional[int] = None      # default d_model // n_heads
    d_ff: int = 512
    vocab_size: int = 256
    act: str = "swiglu"                 # swiglu | gelu | squared_relu
    norm: str = "rmsnorm"               # rmsnorm | layernorm
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False

    # ---- MoE -------------------------------------------------------- #
    n_experts: int = 0                  # 0 = dense FFN
    top_k: int = 1
    n_shared_experts: int = 0
    moe_d_ff: Optional[int] = None      # expert hidden dim (defaults to d_ff)
    capacity_factor: float = 1.25
    moe_chunk: int = 8192               # tokens per dispatch chunk (memory cap)

    # ---- SSM (Mamba-2 SSD) ------------------------------------------ #
    ssm_state: int = 0                  # 0 = no ssm
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # ---- hybrid (RecurrentGemma-style) ------------------------------ #
    # layer pattern repeated over depth; entries: "attn" | "rglru" | "ssm"
    layer_pattern: Tuple[str, ...] = ("attn",)
    window: Optional[int] = None        # sliding window for local attn layers
    rglru_expand: int = 1               # RG-LRU width multiplier (d_rnn = expand*d_model)

    # ---- modality frontend (stubbed: precomputed embeddings) -------- #
    frontend: Optional[str] = None      # None | "audio_frames" | "vision_patches"
    frontend_dim: int = 0               # embedding dim supplied by input_specs
    prefix_len: int = 0                 # patches/frames prepended to text (vlm)

    # ---- serving ----------------------------------------------------- #
    decoder: bool = True                # False => encoder-only (no decode path)
    subquadratic: bool = False          # True => long_500k decode applies

    # ---- training ----------------------------------------------------- #
    train_mode: str = "usec"            # usec (uneven DP loops) | fsdp (GSPMD)
    param_dtype: str = "bfloat16"
    grad_accum_dtype: str = "float32"
    remat: bool = True
    remat_sqrt: bool = False            # two-level remat (measured worse; §Perf)
    remat_save_outs: bool = True        # selective recomputation: save the
                                        # post-collective sublayer outputs so
                                        # remat never re-runs TP reductions
    loss_chunk: int = 512               # sequence chunking for vocab-safe CE
    attn_chunk: int = 1024              # KV block size for chunked attention
    act_shard_axis: str = ""            # mesh axis to shard the residual
                                        # stream's SEQUENCE dim (Megatron-SP)
    act_batch_axes: Tuple[str, ...] = ()  # mesh axes of the residual stream's
                                        # BATCH dim (fsdp mode: the dp axes)
    microbatch_tokens: int = 0          # grad-accum microbatch size target
                                        # (tokens; 0 = auto heuristic)

    # ------------------------------------------------------------------ #
    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_experts and self.moe_d_ff is None:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def n_params(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS = 6·N·D)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * hd
        if self.act in ("swiglu", "geglu"):
            ffn_dense = 3 * d * f
        else:
            ffn_dense = 2 * d * f
        total = 0
        counts = {"attn": 0, "rglru": 0, "ssm": 0}
        pattern = self.layer_pattern
        for i in range(L):
            kind = pattern[i % len(pattern)]
            counts["attn" if kind == "lattn" else kind] += 1
        # attention layers
        total += counts["attn"] * attn
        # rglru layers (conv + gates + recurrence + out)
        d_rnn = self.rglru_expand * d
        total += counts["rglru"] * (2 * d * d_rnn + 2 * d_rnn * self.ssm_conv + 3 * d_rnn + d_rnn * d)
        # ssm layers (mamba2)
        if counts["ssm"]:
            d_in = self.ssm_expand * d
            nheads = d_in // self.ssm_head_dim
            zxbcdt = d * (2 * d_in + 2 * self.ssm_state + nheads)
            total += counts["ssm"] * (zxbcdt + d_in * self.ssm_conv + d_in * d + 2 * nheads)
        # FFN per layer: experts + shared or dense (ssm layers have no FFN)
        n_ffn_layers = counts["attn"] + counts["rglru"]
        if self.is_moe:
            fe = self.moe_d_ff or f
            per_expert = 3 * d * fe if self.act in ("swiglu", "geglu") else 2 * d * fe
            total += n_ffn_layers * (
                self.n_experts * per_expert
                + self.n_shared_experts * per_expert
                + d * self.n_experts  # router
            )
        else:
            total += n_ffn_layers * ffn_dense
        # embeddings + head + norms
        total += v * d * (1 if self.tie_embeddings else 2)
        if self.frontend:
            total += self.frontend_dim * d
        total += (2 * L + 1) * d  # norms (approx)
        return int(total)

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if not self.is_moe:
            return self.n_params()
        fe = self.moe_d_ff or self.d_ff
        per_expert = (3 if self.act in ("swiglu", "geglu") else 2) * self.d_model * fe
        inactive = (self.n_experts - self.top_k) * per_expert * self.n_layers
        return int(self.n_params() - inactive)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        kw = dict(
            n_layers=min(self.n_layers, 2 * max(1, len(self.layer_pattern))),
            d_model=64,
            n_heads=2,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=32,
            d_ff=96,
            vocab_size=128,
            loss_chunk=32,
            attn_chunk=64,
        )
        if self.is_moe:
            kw.update(n_experts=4, top_k=min(self.top_k, 2), moe_d_ff=48)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
        if self.window:
            kw.update(window=32)
        if self.frontend:
            kw.update(frontend_dim=48, prefix_len=min(self.prefix_len, 16))
        if self.rglru_expand:
            kw.update(rglru_expand=1)
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell: what step gets lowered at which sizes."""

    name: str
    kind: str           # train | prefill | decode
    seq_len: int
    global_batch: int
    microbatch: int = 0   # train only; 0 = auto


LM_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4096, 256),
    ShapeConfig("prefill_32k", "prefill", 32768, 32),
    ShapeConfig("decode_32k", "decode", 32768, 128),
    ShapeConfig("long_500k", "decode", 524288, 1),
)


def shape_by_name(name: str) -> ShapeConfig:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def cell_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Skip ledger (DESIGN.md §Arch-applicability)."""
    if shape.kind == "decode" and not cfg.decoder:
        return False, "encoder-only architecture has no decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "full-attention arch: 500k decode needs sub-quadratic attention"
    if shape.kind == "prefill" and not cfg.decoder:
        # encoder-only "prefill" = one full encoder forward; allowed.
        return True, ""
    return True, ""
