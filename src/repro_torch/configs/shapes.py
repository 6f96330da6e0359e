"""The model-input batch schema per (architecture x shape) cell, and the
dry-run's abstract specs.

``demo_batch`` materializes concrete batches of the schema from a numpy
seed, the same values as :func:`repro.configs.shapes.demo_batch`, as numpy
arrays (the caller moves them to its device). ``input_specs`` and
``decode_inputs`` give ``{name: (shape, dtype)}`` (the reference's
``ShapeDtypeStruct``s as plain data), ``cache_specs`` the decode cache as
tensors that hold no memory, and ``micro_batch_size`` the dry-run's
gradient-accumulation size, integer for integer the reference's.

Modality frontends are stubs by assignment: ``[audio]`` supplies precomputed
conv-frame embeddings, ``[vlm]`` supplies precomputed ViT patch embeddings.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from .base import ArchConfig, ShapeConfig


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


def input_specs(cfg: ArchConfig, shape: ShapeConfig, batch: Optional[int] = None,
                seq: Optional[int] = None) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    """{name: (shape, numpy dtype)} of the model inputs of a cell (the
    dry-run builds its tensors from them; nothing is allocated here)."""
    b = batch if batch is not None else shape.global_batch
    s = seq if seq is not None else shape.seq_len
    return batch_schema(cfg, shape.kind, b, s)


def decode_inputs(cfg: ArchConfig, batch: int) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    """The per-step decode inputs (the cache's come from :func:`cache_specs`)."""
    return {"token": ((batch, 1), np.int32)}


def cache_specs(cfg: ArchConfig, batch: int, max_len: int, device="meta"):
    """The decode cache tree of ``init_cache`` with no byte allocated: on
    the meta device (the dry-run's stand-in for the card), or on any other
    device as fake tensors (``FakeTensorMode``)."""
    import torch

    from repro_torch.models.transformer import init_cache

    device = torch.device(device)
    if device.type == "meta":
        return init_cache(cfg, batch, max_len, device=device)
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        return init_cache(cfg, batch, max_len, device=device)


def micro_batch_size(cfg: ArchConfig, shape: ShapeConfig, n_workers: int) -> int:
    """Samples per micro-step per data-parallel worker (gradient
    accumulation), the reference's rule: a microbatch's tokens scale
    inversely with ``d_model`` (``cfg.microbatch_tokens`` overrides), at
    least one sequence, at most the worker's share of the batch."""
    per_worker = max(shape.global_batch // n_workers, 1)
    if getattr(cfg, "microbatch_tokens", 0):
        target_tokens = max(cfg.microbatch_tokens, shape.seq_len)
    else:
        target_tokens = max(int(2 ** 22 / max(cfg.d_model, 1)), shape.seq_len)
    mb = max(target_tokens // shape.seq_len, 1)
    return min(mb, per_worker)
