"""The layer stack: pattern blocks, a loop over layers, prefill/decode.

Twin of :mod:`repro.models.transformer` for the serving path. Every
architecture is an instance of one stack schema:

  embed -> [pattern block] * n_repeats  (+ unrolled remainder layers)
  -> final norm -> unembed

A *pattern block* is ``cfg.layer_pattern`` applied in order. Ported layer
kinds: "attn" (global GQA attention + FFN) and "lattn" (sliding-window
attention + FFN); the FFN is dense, or the MoE of :mod:`.moe` when
``cfg.is_moe``. Homogeneous-layer params and caches are stacked on a
leading ``n_repeats`` axis, the reference's ``lax.scan`` layout, and the
stack runs as a Python loop over that axis; the remainder layers
(depth % pattern) have their own params and caches. The "rglru" and "ssm"
kinds and training raise ``NotImplementedError`` naming their ROADMAP.md
item.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from . import attention as attn_mod
from . import moe as moe_mod
from .layers import apply_mlp, apply_norm, dtype_of, init_mlp, init_norm

PORTED_KINDS = ("attn", "lattn")
_ROADMAP = {
    "rglru": "the rglru layer kind: ROADMAP.md Queue 1 item 12c",
    "ssm": "the ssm layer kind: ROADMAP.md Queue 1 item 12c",
    "frontend": "modality frontends and encoder-only models: "
                "ROADMAP.md Queue 1 item 12d",
    "train": "training (losses.py, stack_train, optim): "
             "ROADMAP.md Queue 1 item 13",
}


def not_ported(what: str) -> NotImplementedError:
    """The error for a part of the reference model stack not ported yet."""
    return NotImplementedError(
        f"{_ROADMAP[what]} (not ported to repro_torch yet)")


def require_ported(cfg) -> None:
    """Raise ``NotImplementedError`` unless every layer of ``cfg`` is of a
    ported kind."""
    for kind in cfg.layer_pattern:
        if kind not in PORTED_KINDS:
            raise not_ported(kind) if kind in _ROADMAP else ValueError(kind)


# ---------------------------------------------------------------------- #
# Parameter / cache trees (nested dicts and lists of tensors)
# ---------------------------------------------------------------------- #
def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a tree of dicts, lists and tuples, in
    JAX's pytree order (dict keys sorted); ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree, as views."""
    return tree_map(lambda t: t[i], tree)


# ---------------------------------------------------------------------- #
# Per-layer init / apply
# ---------------------------------------------------------------------- #
def _init_layer(generator, kind: str, cfg, device, lead=()) -> Dict:
    dt = dtype_of(cfg.param_dtype)
    return {
        "norm1": init_norm(cfg.d_model, cfg.norm, dt, device, lead),
        "temporal": attn_mod.init_attention(generator, cfg, device, lead),
        "norm2": init_norm(cfg.d_model, cfg.norm, dt, device, lead),
        "ffn": (moe_mod.init_moe(generator, cfg, device, lead) if cfg.is_moe
                else init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.act, dt,
                              device, lead)),
    }


def _apply_ffn(p, x, cfg):
    """(out, aux): the MoE FFN and its load-balance loss, or the dense FFN
    and a zero aux (the reference's branches without their GSPMD sharding
    hints)."""
    if cfg.is_moe:
        return moe_mod.apply_moe(p, x, cfg)
    return apply_mlp(p, x, cfg.act), torch.zeros((), dtype=torch.float32,
                                                  device=x.device)


def _window(kind: str, cfg):
    return cfg.window if kind == "lattn" else None


def _layer_prefill(kind: str, p: Dict, x, cfg, positions):
    """Pre-norm attention + FFN over the prompt; also this layer's cache."""
    h = apply_norm(p["norm1"], x, cfg.norm)
    t, cache = attn_mod.attention_prefill(p["temporal"], h, cfg, positions,
                                          window=_window(kind, cfg))
    x = x + t.to(x.dtype)
    h2 = apply_norm(p["norm2"], x, cfg.norm)
    f, _ = _apply_ffn(p["ffn"], h2, cfg)
    return x + f.to(x.dtype), cache


def _layer_decode(kind: str, p: Dict, x, cache, cache_pos, cfg):
    h = apply_norm(p["norm1"], x, cfg.norm)
    t, new_cache = attn_mod.attention_decode(p["temporal"], h, cache,
                                             cache_pos, cfg,
                                             window=_window(kind, cfg))
    x = x + t.to(x.dtype)
    h2 = apply_norm(p["norm2"], x, cfg.norm)
    f, _ = _apply_ffn(p["ffn"], h2, cfg)
    return x + f.to(x.dtype), new_cache


# ---------------------------------------------------------------------- #
# Stack init
# ---------------------------------------------------------------------- #
def stack_layout(cfg) -> Tuple[int, List[str]]:
    """(n_repeats, extra_kinds)."""
    plen = len(cfg.layer_pattern)
    n_rep = cfg.n_layers // plen
    n_extra = cfg.n_layers - n_rep * plen
    return n_rep, [cfg.layer_pattern[i % plen] for i in range(n_extra)]


def init_stack(generator, cfg, device=None) -> Dict:
    require_ported(cfg)
    n_rep, extra_kinds = stack_layout(cfg)
    blocks = [_init_layer(generator, kind, cfg, device, (n_rep,))
              if n_rep > 0 else None for kind in cfg.layer_pattern]
    extras = [_init_layer(generator, kind, cfg, device)
              for kind in extra_kinds]
    return {"blocks": blocks, "extras": extras}


def init_cache(cfg, batch: int, max_len: int, device=None) -> Dict:
    """Stacked decode caches matching the stacked-layer layout."""
    require_ported(cfg)
    n_rep, extra_kinds = stack_layout(cfg)

    def one(kind, lead=()):
        return attn_mod.init_kv_cache(cfg, batch, max_len,
                                      window=_window(kind, cfg),
                                      device=device, lead=lead)

    blocks = [one(kind, (n_rep,)) if n_rep > 0 else None
              for kind in cfg.layer_pattern]
    return {"blocks": blocks, "extras": [one(kind) for kind in extra_kinds]}


# ---------------------------------------------------------------------- #
# Stack apply
# ---------------------------------------------------------------------- #
def stack_prefill(params: Dict, x: torch.Tensor, cfg, positions) -> Tuple[torch.Tensor, Dict]:
    pattern = cfg.layer_pattern
    n_rep, extra_kinds = stack_layout(cfg)
    per_pos: List[List[Dict]] = [[] for _ in pattern]
    for i in range(n_rep):
        for pos, kind in enumerate(pattern):
            x, c = _layer_prefill(kind, _layer(params["blocks"][pos], i), x,
                                  cfg, positions)
            per_pos[pos].append(c)
    caches = [{k: torch.stack([c[k] for c in cs]) for k in cs[0]}
              if cs else None for cs in per_pos]
    extra_caches = []
    for p_extra, kind in zip(params["extras"], extra_kinds):
        x, c = _layer_prefill(kind, p_extra, x, cfg, positions)
        extra_caches.append(c)
    return x, {"blocks": caches, "extras": extra_caches}


def stack_decode(params: Dict, x: torch.Tensor, cache: Dict, cache_pos, cfg) -> Tuple[torch.Tensor, Dict]:
    """One token through every layer; each layer's cache is a view of the
    stacked cache and is updated in place, so the returned cache is
    ``cache``."""
    pattern = cfg.layer_pattern
    n_rep, extra_kinds = stack_layout(cfg)
    for i in range(n_rep):
        for pos, kind in enumerate(pattern):
            x, _ = _layer_decode(kind, _layer(params["blocks"][pos], i), x,
                                 _layer(cache["blocks"][pos], i), cache_pos,
                                 cfg)
    for p_extra, c_extra, kind in zip(params["extras"], cache["extras"],
                                      extra_kinds):
        x, _ = _layer_decode(kind, p_extra, x, c_extra, cache_pos, cfg)
    return x, cache
