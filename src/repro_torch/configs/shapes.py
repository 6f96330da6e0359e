"""The model-input batch schema per (architecture x shape) cell.

``demo_batch`` materializes concrete batches of the schema from a numpy
seed, the same values as :func:`repro.configs.shapes.demo_batch`, as numpy
arrays (the caller moves them to its device).

Modality frontends are stubs by assignment: ``[audio]`` supplies precomputed
conv-frame embeddings, ``[vlm]`` supplies precomputed ViT patch embeddings.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .base import ArchConfig


def batch_schema(cfg: ArchConfig, kind: str, batch: int, seq: int) -> Dict[str, Tuple[Tuple[int, ...], type]]:
    """{name: (shape, numpy dtype)} for the model-input batch."""
    if cfg.frontend == "audio_frames":
        d = {"frames": ((batch, seq, cfg.frontend_dim), np.float32)}
        if kind == "train":
            d["labels"] = ((batch, seq), np.int32)
        return d
    if cfg.frontend == "vision_patches":
        p = min(cfg.prefix_len, max(seq // 4, 1))
        return {
            "patches": ((batch, p, cfg.frontend_dim), np.float32),
            "tokens": ((batch, seq - p), np.int32),
        }
    return {"tokens": ((batch, seq), np.int32)}


def demo_batch(cfg: ArchConfig, kind: str, batch: int, seq: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """Concrete batch with the schema (smoke tests / the serving demo)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shp, dt) in batch_schema(cfg, kind, batch, seq).items():
        if dt == np.int32:
            out[k] = rng.integers(0, cfg.vocab_size, size=shp).astype(np.int32)
        else:
            out[k] = rng.normal(size=shp).astype(np.float32)
    return out
