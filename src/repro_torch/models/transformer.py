"""The layer stack: pattern blocks, a loop over layers, train/prefill/decode.

Twin of :mod:`repro.models.transformer`. Every architecture is an instance
of one stack schema:

  embed (tokens and/or the stubbed modality frontend)
  -> [pattern block] * n_repeats  (+ unrolled remainder layers)
  -> final norm -> unembed

A *pattern block* is ``cfg.layer_pattern`` applied in order; entries:
  "attn"   — global GQA attention + FFN (dense, or the MoE of :mod:`.moe`
             when ``cfg.is_moe``); bidirectional in an encoder
  "lattn"  — sliding-window attention + FFN
  "rglru"  — RG-LRU recurrent block + FFN        (RecurrentGemma)
  "ssm"    — Mamba-2 SSD block, no separate FFN  (mamba2)

Homogeneous-layer params and caches are stacked on a leading ``n_repeats``
axis, the reference's ``lax.scan`` layout, and the stack runs as a Python
loop over that axis; the remainder layers (depth % pattern) have their own
params and caches. Training under ``cfg.remat`` recomputes activations
in the backward (``torch.utils.checkpoint``, the reference's
``jax.checkpoint``) by one of the reference's three policies, which trade
memory against time and change no value (:func:`stack_train`). Decode hands
each layer views of the stacked cache and every layer kind updates them in
place.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as attn_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from .layers import apply_mlp, apply_norm, dtype_of, init_mlp, init_norm, mlp_parts
from .parallel import finish, gather_from_data, gather_tree, over


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


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


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


def _temporal_train(kind: str, norm1: Dict, p: Dict, x, cfg, positions,
                    tp=None, dp=None, dims=None):
    """A layer's pre-norm temporal mixer: its sublayer output's (partial,
    whole) parts (:func:`repro_torch.models.parallel.finish`). ``dp`` and
    ``dims``: the data group and the data dims of ``(norm1, p)``; the cut
    leaves are gathered here, inside any checkpoint around the call, so a
    recompute gathers them again."""
    norm1, p = gather_tree((norm1, p), dims, dp)
    h = apply_norm(norm1, x, cfg.norm)
    if kind in ("attn", "lattn"):
        return attn_mod.attention_parts(p, h, cfg, positions,
                                        window=_window(kind, cfg),
                                        causal=cfg.decoder, tp=tp)
    if kind == "rglru":
        return rglru_mod.rglru_parts(p, h, cfg, tp)
    return ssm_mod.ssm_parts(p, h, cfg, tp)


def _ffn_train(norm2: Dict, p: Dict, x, cfg, tp=None, dp=None, dims=None):
    """A layer's pre-norm FFN: (its sublayer output's parts, the MoE aux);
    ``dp`` and ``dims`` as in :func:`_temporal_train`. Over a data group
    the MoE routes the whole microbatch, as one process does: its tokens
    are gathered over the group (capacity and the load-balance loss span
    every rank's rows) and each rank keeps its rows' outputs."""
    norm2, p = gather_tree((norm2, p), dims, dp)
    h = apply_norm(norm2, x, cfg.norm)
    if cfg.is_moe:
        if dp is None or dp.size == 1:
            return moe_mod.moe_parts(p, h, cfg, tp)
        rows = h.shape[0]
        parts, aux = moe_mod.moe_parts(p, gather_from_data(h, dp, 0), cfg,
                                       tp)
        return tuple(None if y is None else y.narrow(0, dp.rank * rows, rows)
                     for y in parts), aux
    ftp = over(tp, p["w_up"].shape[-1], cfg.d_ff)
    return mlp_parts(p, h, cfg.act, ftp), torch.zeros(
        (), dtype=torch.float32, device=x.device)


def _layer_train(kind: str, p: Dict, x, cfg, positions,
                 save_outs: bool = False, tp=None, dp=None, dims=None):
    """One layer over a full sequence with its MoE aux (0 for a dense or
    ssm layer); attention is causal in a decoder, bidirectional in an
    encoder. The reference's ``_seq_shard`` is a sharding constraint, a
    no-op on one card. ``save_outs``: checkpoint each sublayer on its own,
    so autograd keeps the residual stream at the sublayer boundaries (the
    reference's saved ``temporal_out`` and ``ffn_out``) and recomputes
    only the sublayers' insides. ``tp``: the model group; each sublayer's
    partial sums are reduced outside its checkpoint, so the recompute
    never runs that reduction again (the reference's reason for the
    policy; a gather inside a sublayer does run again). ``dp`` and
    ``dims``: the data group and the data dims of ``p``'s leaves (each
    sublayer gathers its own)."""
    def run(fn, *args):
        if save_outs:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def sub(*keys):
        return None if dims is None else tuple(dims[k] for k in keys)

    t = finish(run(_temporal_train, kind, p["norm1"], p["temporal"], x, cfg,
                   positions, tp, dp, sub("norm1", "temporal")), tp)
    x = x + t.to(x.dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind != "ssm":
        parts, aux = run(_ffn_train, p["norm2"], p["ffn"], x, cfg, tp, dp,
                         sub("norm2", "ffn"))
        x = x + finish(parts, tp).to(x.dtype)
    return x, aux


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
    n_rep, extra_kinds = stack_layout(cfg)
    blocks = [_init_layer(generator, kind, cfg, device, (n_rep,))
              if n_rep > 0 else None for kind in cfg.layer_pattern]
    extras = [_init_layer(generator, kind, cfg, device)
              for kind in extra_kinds]
    return {"blocks": blocks, "extras": extras}


def init_cache(cfg, batch: int, max_len: int, device=None) -> Dict:
    """Stacked decode caches matching the stacked-layer layout (an
    encoder's too: the reference builds them for every arch)."""
    n_rep, extra_kinds = stack_layout(cfg)

    def one(kind, lead=()):
        if kind == "rglru":
            return rglru_mod.init_rglru_cache(cfg, batch, device, lead)
        if kind == "ssm":
            return ssm_mod.init_ssm_cache(cfg, batch, device, lead)
        if kind not in ("attn", "lattn"):
            raise ValueError(kind)
        return attn_mod.init_kv_cache(cfg, batch, max_len,
                                      window=_window(kind, cfg),
                                      device=device, lead=lead)

    blocks = [one(kind, (n_rep,)) if n_rep > 0 else None
              for kind in cfg.layer_pattern]
    return {"blocks": blocks, "extras": [one(kind) for kind in extra_kinds]}


# ---------------------------------------------------------------------- #
# Stack apply
# ---------------------------------------------------------------------- #
def _inner_factor(n: int) -> int:
    """Largest divisor of n not exceeding sqrt(n) (sqrt-remat grouping)."""
    best = 1
    d = 1
    while d * d <= n:
        if n % d == 0:
            best = d
        d += 1
    return best


def stack_train(params: Dict, x: torch.Tensor, cfg, positions,
                tp=None, dp=None, dims=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stack over a full sequence: (h, aux), the MoE aux summed over
    layers in the reference's order. With ``cfg.remat`` and grad enabled,
    the pattern blocks recompute in the backward by the reference's
    policies, in its order of precedence:

    - ``cfg.remat_sqrt`` with ``_inner_factor(n_repeats) > 1``: two-level
      remat. Each group of that many blocks is one checkpoint, so autograd
      keeps only the groups' inputs and, in the backward, runs one group's
      forward again with everything it needs kept.
    - ``cfg.remat_save_outs``: each sublayer is a checkpoint of its own
      (:func:`_layer_train`); the residual stream at the sublayer
      boundaries is kept.
    - otherwise each pattern block is one checkpoint: autograd keeps its
      input and runs its forward again in the backward.

    Each runs every layer's forward twice (once again in the backward); the
    remainder layers are never checkpointed. ``tp``: the model group
    (:mod:`repro_torch.models.parallel`). Under the first and third
    policies a block's recompute runs its collectives again; that is right
    only while every rank of the group recomputes its blocks in the same
    order, which autograd does (the same graph on every rank).
    ``remat_save_outs`` reduces each sublayer outside its checkpoint.

    ``dp`` and ``dims``: the data group and the data dims of ``params``'
    leaves (a tree shaped like them; a stacked leaf's dim counts its layer
    axis, which is never cut). Each sublayer gathers its cut leaves when it
    runs, inside the checkpoints, so no whole layer outlives its use; every
    rank of the group runs the same layers, so the gathers meet."""
    pattern = cfg.layer_pattern
    n_rep, extra_kinds = stack_layout(cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    n_inner = _inner_factor(n_rep) if remat and cfg.remat_sqrt else 1
    save_outs = remat and n_inner == 1 and cfg.remat_save_outs
    dims = dims if dp is not None else None
    layer_dims = [None if dims is None else tree_map(lambda d: d - 1, b)
                  for b in (dims["blocks"] if dims else pattern)]

    def blocks(h, aux, first, last):
        for i in range(first, last):
            for pos, kind in enumerate(pattern):
                h, a = _layer_train(kind, _layer(params["blocks"][pos], i), h,
                                    cfg, positions, save_outs, tp, dp,
                                    layer_dims[pos])
                aux = aux + a
        return h, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if remat and not save_outs:  # a checkpoint per block or per group
        for first in range(0, n_rep, n_inner):
            x, aux = checkpoint(blocks, x, aux, first, first + n_inner,
                                use_reentrant=False)
    else:
        x, aux = blocks(x, aux, 0, n_rep)
    extra_dims = dims["extras"] if dims else [None] * len(extra_kinds)
    for p_extra, kind, d in zip(params["extras"], extra_kinds, extra_dims):
        x, a = _layer_train(kind, p_extra, x, cfg, positions, tp=tp, dp=dp,
                            dims=d)
        aux = aux + a
    return x, aux


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
