"""The layer stack: pattern blocks, a loop over layers, prefill/decode.

Twin of :mod:`repro.models.transformer` for the serving path. Every
architecture is an instance of one stack schema:

  embed -> [pattern block] * n_repeats  (+ unrolled remainder layers)
  -> final norm -> unembed

A *pattern block* is ``cfg.layer_pattern`` applied in order; entries:
  "attn"   — global GQA attention + FFN (dense, or the MoE of :mod:`.moe`
             when ``cfg.is_moe``)
  "lattn"  — sliding-window attention + FFN
  "rglru"  — RG-LRU recurrent block + FFN        (RecurrentGemma)
  "ssm"    — Mamba-2 SSD block, no separate FFN  (mamba2)

Homogeneous-layer params and caches are stacked on a leading ``n_repeats``
axis, the reference's ``lax.scan`` layout, and the stack runs as a Python
loop over that axis; the remainder layers (depth % pattern) have their own
params and caches. Decode hands each layer views of the stacked cache and
every layer kind updates them in place. Training raises
``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from . import attention as attn_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from .layers import apply_mlp, apply_norm, dtype_of, init_mlp, init_norm

PORTED_KINDS = ("attn", "lattn", "rglru", "ssm")
_ROADMAP = {
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
    p: Dict[str, Any] = {"norm1": init_norm(cfg.d_model, cfg.norm, dt,
                                            device, lead)}
    if kind in ("attn", "lattn"):
        p["temporal"] = attn_mod.init_attention(generator, cfg, device, lead)
    elif kind == "rglru":
        p["temporal"] = rglru_mod.init_rglru(generator, cfg, device, lead)
    elif kind == "ssm":
        p["temporal"] = ssm_mod.init_ssm(generator, cfg, device, lead)
    else:
        raise ValueError(kind)
    if kind != "ssm":
        p["norm2"] = init_norm(cfg.d_model, cfg.norm, dt, device, lead)
        p["ffn"] = (moe_mod.init_moe(generator, cfg, device, lead)
                    if cfg.is_moe else
                    init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.act, dt,
                             device, lead))
    return p


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


def _ffn_residual(kind: str, p: Dict, x, cfg):
    """The pre-norm FFN and its residual (none after an ssm block)."""
    if kind == "ssm":
        return x
    h2 = apply_norm(p["norm2"], x, cfg.norm)
    f, _ = _apply_ffn(p["ffn"], h2, cfg)
    return x + f.to(x.dtype)


def _layer_prefill(kind: str, p: Dict, x, cfg, positions):
    """One layer over the prompt; also this layer's decode cache."""
    h = apply_norm(p["norm1"], x, cfg.norm)
    if kind in ("attn", "lattn"):
        t, cache = attn_mod.attention_prefill(p["temporal"], h, cfg,
                                              positions,
                                              window=_window(kind, cfg))
    elif kind == "rglru":
        t, cache = rglru_mod.rglru_prefill(p["temporal"], h, cfg)
    else:
        t, cache = _ssm_prefill(p["temporal"], h, cfg)
    return _ffn_residual(kind, p, x + t.to(x.dtype), cfg), cache


def _layer_decode(kind: str, p: Dict, x, cache, cache_pos, cfg):
    """One token through one layer; ``cache`` is updated in place."""
    h = apply_norm(p["norm1"], x, cfg.norm)
    if kind in ("attn", "lattn"):
        t, cache = attn_mod.attention_decode(p["temporal"], h, cache,
                                             cache_pos, cfg,
                                             window=_window(kind, cfg))
    elif kind == "rglru":
        t, cache = rglru_mod.apply_rglru_decode(p["temporal"], h, cache, cfg)
    else:
        t, cache = ssm_mod.apply_ssm_decode(p["temporal"], h, cache, cfg)
    return _ffn_residual(kind, p, x + t.to(x.dtype), cfg), cache


def _ssm_prefill(p, h, cfg):
    """SSD forward + final (conv, state) caches for streaming decode. The
    in-projection and conv run once (the reference runs them again for the
    caches; the values are identical). The state is the reference's
    closed form, sum_t exp(sum_{u>t} dt_u A) dt_t B_t x_t^T, from a
    reversed cumsum."""
    z, xbc, x, b, c, dt, _ = ssm_mod._in_proj(p, h, cfg)
    y = ssm_mod.ssm_forward(p, z, x, b, c, dt, cfg)
    conv_state = xbc[:, -(cfg.ssm_conv - 1):, :]
    a = -torch.exp(p["A_log"])
    bsz, s, _ = x.shape
    xh = x.reshape(bsz, s, -1, cfg.ssm_head_dim).to(torch.float32)
    da = (dt * a).transpose(1, 2)  # (B,H,S): the cumsum's axis last
    rev_cum = torch.flip(torch.cumsum(torch.flip(da, (-1,)), dim=-1),
                         (-1,)) - da  # sum_{u>t}
    w_t = torch.exp(rev_cum).transpose(1, 2)  # (B,S,H)
    state = torch.einsum("bsn,bsh,bshp->bhpn", b.to(torch.float32),
                         w_t * dt, xh)
    return y, {"conv": conv_state, "state": state}


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
        if kind == "rglru":
            return rglru_mod.init_rglru_cache(cfg, batch, device, lead)
        if kind == "ssm":
            return ssm_mod.init_ssm_cache(cfg, batch, device, lead)
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
