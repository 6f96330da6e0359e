"""build_model(cfg) -> ModelBundle: init / prefill / decode.

Twin of :mod:`repro.models.model` for the serving path of decoder-only LM
families (batch ``{"tokens": (B, S) int}``). Parameters are the reference's
nested dicts of arrays as dicts of tensors, in the same layout and dtypes;
:func:`params_from_reference` carries a reference tree (as numpy) across.
Training (``loss_fn``), the audio-encoder and VLM frontends raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device

from .layers import apply_norm, dense_init, dtype_of, init_norm, normal_
from .transformer import (
    init_cache,
    init_stack,
    not_ported,
    require_ported,
    stack_decode,
    stack_prefill,
    tree_leaves,
)


@dataclass
class ModelBundle:
    cfg: Any
    init: Callable         # (generator) -> params, on ``device``
    loss_fn: Callable      # raises: training is not ported
    prefill: Callable      # (params, batch) -> (cache, last_logits)
    decode_step: Callable  # (params, cache, token, cache_pos) -> (cache, logits)
    device: torch.device


def build_model(cfg, device=None) -> ModelBundle:
    """The bundle for ``cfg`` on ``device`` (CUDA unless named; raises
    without a GPU and no explicit device)."""
    if cfg.frontend or not cfg.decoder:
        raise not_ported("frontend")
    require_ported(cfg)
    device = resolve_device(device)
    dt = dtype_of(cfg.param_dtype)

    def init(generator: torch.Generator) -> Dict:
        """Random weights from ``generator`` (on ``device``), every leaf
        allocated on the device in ``cfg.param_dtype`` (an MoE router in
        fp32, as the reference's)."""
        embed = torch.empty((cfg.vocab_size, cfg.d_model), dtype=dt,
                            device=device)
        p: Dict[str, Any] = {
            "embed": normal_(embed, generator, 0.02),
            "stack": init_stack(generator, cfg, device),
            "final_norm": init_norm(cfg.d_model, cfg.norm, dt, device),
        }
        if not cfg.tie_embeddings:
            p["unembed"] = dense_init(generator, cfg.d_model, cfg.vocab_size,
                                      dt, scale=0.02, device=device)
        return p

    def unembed_of(params):
        if cfg.tie_embeddings:
            return params["embed"].T
        return params["unembed"]

    def embed(params, tokens) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, device=device).long()
        return params["embed"][tokens]

    def loss_fn(params, batch):
        raise not_ported("train")

    def prefill(params, batch):
        x = embed(params, batch["tokens"])
        positions = torch.arange(x.shape[1], device=device)
        h, cache = stack_prefill(params["stack"], x, cfg, positions)
        h = apply_norm(params["final_norm"], h, cfg.norm)
        logits = (h[:, -1] @ unembed_of(params)).to(torch.float32)
        return cache, logits

    def decode_step(params, cache, token, cache_pos):
        """One token (B, 1) at position ``cache_pos``; ``cache`` is updated
        in place and returned."""
        x = embed(params, token)  # (B, 1, D)
        h, cache = stack_decode(params["stack"], x, cache, cache_pos, cfg)
        h = apply_norm(params["final_norm"], h, cfg.norm)
        logits = (h[:, 0] @ unembed_of(params)).to(torch.float32)
        return cache, logits

    return ModelBundle(cfg, init, loss_fn, prefill, decode_step, device)


def make_cache(cfg, batch: int, max_len: int, device=None):
    return init_cache(cfg, batch, max_len, device=resolve_device(device))


def param_count(params) -> int:
    return int(sum(t.numel() for t in tree_leaves(params)))


def _tensor(a) -> torch.Tensor:
    """A writable copy of array ``a`` as a host tensor of the same dtype."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_reference(tree, cfg, device=None) -> Dict:
    """The reference's params (``jax.tree.map(np.asarray, params)``) as the
    port's tree on ``device``, leaf for leaf with the same dtypes. Raises if
    a leaf is not in ``cfg.param_dtype``, except an MoE ``router``, which
    the reference keeps in fp32."""
    device = resolve_device(device)
    dt = dtype_of(cfg.param_dtype)

    def carry(node, key=None):
        if isinstance(node, dict):
            return {k: carry(node[k], k) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(carry(v, key) for v in node)
        if node is None:
            return None
        t = _tensor(node)
        want = torch.float32 if key == "router" and cfg.is_moe else dt
        if t.dtype != want:
            raise ValueError(f"leaf {key!r} of dtype {t.dtype}, want {want}")
        return t.to(device)

    return carry(tree)
