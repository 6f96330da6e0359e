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
memory against time and change no value (:func:`stack_train`). Over a
model group with ``cfg.act_shard_axis`` set, the training residual stream
between sublayers is each rank's slice of the sequence
(:class:`repro_torch.models.parallel.SeqCut`). Decode hands
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
from .layers import apply_norm, dtype_of, init_mlp, init_norm, mlp_parts
from .parallel import at, finish, gather_from_data, gather_tree, over


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
def _init_layer(generator, kind: str, cfg, device, lead=(), cut=None
                ) -> Dict:
    dt = dtype_of(cfg.param_dtype)
    p: Dict[str, Any] = {"norm1": init_norm(cfg.d_model, cfg.norm, dt,
                                            device, lead, at(cut, "norm1"))}
    temporal = at(cut, "temporal")
    if kind in ("attn", "lattn"):
        p["temporal"] = attn_mod.init_attention(generator, cfg, device, lead,
                                                temporal)
    elif kind == "rglru":
        p["temporal"] = rglru_mod.init_rglru(generator, cfg, device, lead,
                                             temporal)
    elif kind == "ssm":
        p["temporal"] = ssm_mod.init_ssm(generator, cfg, device, lead,
                                         temporal)
    else:
        raise ValueError(kind)
    if kind != "ssm":
        p["norm2"] = init_norm(cfg.d_model, cfg.norm, dt, device, lead,
                               at(cut, "norm2"))
        p["ffn"] = (moe_mod.init_moe(generator, cfg, device, lead,
                                     at(cut, "ffn"))
                    if cfg.is_moe else
                    init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.act, dt,
                             device, lead, at(cut, "ffn")))
    return p


def _window(kind: str, cfg):
    return cfg.window if kind == "lattn" else None


def _temporal_train(kind: str, norm1: Dict, p: Dict, x, cfg, positions,
                    tp=None, dp=None, dims=None, seq=None):
    """A layer's pre-norm temporal mixer: its sublayer output's (partial,
    whole) parts (:func:`repro_torch.models.parallel.finish`). ``dp`` and
    ``dims``: the data group and the data dims of ``(norm1, p)``; the cut
    leaves are gathered here, inside any checkpoint around the call, so a
    recompute gathers them again. ``seq``: ``x`` is this rank's slice of
    the sequence (a :class:`repro_torch.models.parallel.SeqCut`), gathered
    whole here in the same way."""
    norm1, p = gather_tree((norm1, p), dims, dp)
    if seq is not None:
        x = seq.gather(x)
    h = apply_norm(norm1, x, cfg.norm)
    if kind in ("attn", "lattn"):
        return attn_mod.attention_parts(p, h, cfg, positions,
                                        window=_window(kind, cfg),
                                        causal=cfg.decoder, tp=tp)
    if kind == "rglru":
        return rglru_mod.rglru_parts(p, h, cfg, tp)
    return ssm_mod.ssm_parts(p, h, cfg, tp)


def _ffn_train(norm2: Dict, p: Dict, x, cfg, tp=None, dp=None, dims=None,
               row_cut: bool = True, seq=None):
    """A layer's pre-norm FFN: (its sublayer output's parts, the MoE aux);
    ``dp``, ``dims`` and ``seq`` as in :func:`_temporal_train`. Over a
    data group the MoE routes the whole microbatch, as one process does:
    its tokens are gathered over the group (capacity and the load-balance
    loss span every rank's rows) and each rank keeps its rows' outputs; a
    sequence cut is gathered first, so the MoE routes the whole sequence
    (each rank's experts' (E/M, C, D) buffers hold their tokens of it, the
    reference's expert-axis pins). ``row_cut`` False: ``x`` holds every
    row of the batch already (a batch the data axis does not divide,
    served whole by every data index)."""
    norm2, p = gather_tree((norm2, p), dims, dp)
    if seq is not None:
        x = seq.gather(x)
    h = apply_norm(norm2, x, cfg.norm)
    if cfg.is_moe:
        if dp is None or dp.size == 1 or not row_cut:
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
                 save_outs: bool = False, tp=None, dp=None, dims=None,
                 seq=None):
    """One layer over a full sequence with its MoE aux (0 for a dense or
    ssm layer); attention is causal in a decoder, bidirectional in an
    encoder. ``save_outs``: checkpoint each sublayer on its own, so
    autograd keeps the residual stream at the sublayer boundaries (the
    reference's saved ``temporal_out`` and ``ffn_out``) and recomputes
    only the sublayers' insides. ``tp``: the model group; each sublayer's
    partial sums are reduced outside its checkpoint, so the recompute
    never runs that reduction again (the reference's reason for the
    policy; a gather inside a sublayer does run again). ``dp`` and
    ``dims``: the data group and the data dims of ``p``'s leaves (each
    sublayer gathers its own). ``seq``: the reference's ``_seq_shard``
    (a :class:`repro_torch.models.parallel.SeqCut`): ``x`` and the result
    are this rank's slices of the sequence; each sublayer gathers its
    input whole inside its checkpoint and reduce-scatters its partial
    sums outside it; ``positions`` stays the whole sequence's."""
    def run(fn, *args):
        if save_outs:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def sub(*keys):
        return None if dims is None else tuple(dims[k] for k in keys)

    cut = seq is not None
    t = finish(run(_temporal_train, kind, p["norm1"], p["temporal"], x, cfg,
                   positions, tp, dp, sub("norm1", "temporal"), seq), tp, cut)
    x = x + t.to(x.dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind != "ssm":
        parts, aux = run(_ffn_train, p["norm2"], p["ffn"], x, cfg, tp, dp,
                         sub("norm2", "ffn"), True, seq)
        x = x + finish(parts, tp, cut).to(x.dtype)
    return x, aux


def _layer_prefill(kind: str, p: Dict, x, cfg, positions, tp=None,
                   dp=None, dims=None, cdims=None, row_cut: bool = True):
    """One layer over the prompt; also this layer's decode cache. ``tp``,
    ``dp`` and ``dims`` as in :func:`_layer_train` (each sublayer gathers
    its data-cut leaves when it runs); ``cdims``: the model dims of this
    layer's cache leaves, counted from the end (None whole), by which the
    cache comes back cut; ``row_cut`` as in :func:`_ffn_train`."""
    def sub(*keys):
        return None if dims is None else tuple(dims[k] for k in keys)

    norm1, pt = gather_tree((p["norm1"], p["temporal"]),
                            sub("norm1", "temporal"), dp)
    h = apply_norm(norm1, x, cfg.norm)
    if kind in ("attn", "lattn"):
        parts, cache = attn_mod.attention_prefill_parts(
            pt, h, cfg, positions, _window(kind, cfg), tp,
            None if cdims is None else cdims["k"])
    elif kind == "rglru":
        parts, cache = rglru_mod.rglru_prefill_parts(
            pt, h, cfg, tp, cut=cdims is not None and cdims["h"] is not None)
    else:
        parts, cache = ssm_mod.ssm_prefill_parts(pt, h, cfg, tp, cdims)
    x = x + finish(parts, tp).to(x.dtype)
    if kind != "ssm":
        parts, _ = _ffn_train(p["norm2"], p["ffn"], x, cfg, tp, dp,
                              sub("norm2", "ffn"), row_cut)
        x = x + finish(parts, tp).to(x.dtype)
    return x, cache


def _layer_decode(kind: str, p: Dict, x, cache, cache_pos, cfg, tp=None,
                  dp=None, dims=None, cdims=None, row_cut: bool = True):
    """One token through one layer; ``cache`` (this rank's cut) is updated
    in place. The other arguments as in :func:`_layer_prefill`."""
    def sub(*keys):
        return None if dims is None else tuple(dims[k] for k in keys)

    norm1, pt = gather_tree((p["norm1"], p["temporal"]),
                            sub("norm1", "temporal"), dp)
    h = apply_norm(norm1, x, cfg.norm)
    if kind in ("attn", "lattn"):
        parts, cache = attn_mod.attention_decode_parts(
            pt, h, cache, cache_pos, cfg, _window(kind, cfg), tp,
            None if cdims is None else cdims["k"])
    elif kind == "rglru":
        parts, cache = rglru_mod.rglru_decode_parts(
            pt, h, cache, cfg, tp,
            cut=cdims is not None and cdims["h"] is not None)
    else:
        parts, cache = ssm_mod.ssm_decode_parts(pt, h, cache, cfg, tp, cdims)
    x = x + finish(parts, tp).to(x.dtype)
    if kind != "ssm":
        parts, _ = _ffn_train(p["norm2"], p["ffn"], x, cfg, tp, dp,
                              sub("norm2", "ffn"), row_cut)
        x = x + finish(parts, tp).to(x.dtype)
    return x, cache


def _ssm_prefill(p, h, cfg):
    """SSD forward + final (conv, state) caches for streaming decode
    (:func:`repro_torch.models.ssm.ssm_prefill_parts` on one shard)."""
    parts, cache = ssm_mod.ssm_prefill_parts(p, h, cfg)
    return parts[1], cache


# ---------------------------------------------------------------------- #
# Stack init
# ---------------------------------------------------------------------- #
def stack_layout(cfg) -> Tuple[int, List[str]]:
    """(n_repeats, extra_kinds)."""
    plen = len(cfg.layer_pattern)
    n_rep = cfg.n_layers // plen
    n_extra = cfg.n_layers - n_rep * plen
    return n_rep, [cfg.layer_pattern[i % plen] for i in range(n_extra)]


def init_stack(generator, cfg, device=None, cut=None) -> Dict:
    """The stack's parameters; ``cut`` (an
    :class:`repro_torch.models.parallel.InitCut` at ``stack``): this rank's
    slices of them, drawn as the whole tree is."""
    n_rep, extra_kinds = stack_layout(cfg)
    blocks = [_init_layer(generator, kind, cfg, device, (n_rep,),
                          at(cut, "blocks", pos))
              if n_rep > 0 else None
              for pos, kind in enumerate(cfg.layer_pattern)]
    extras = [_init_layer(generator, kind, cfg, device, cut=at(cut, "extras",
                                                               i))
              for i, kind in enumerate(extra_kinds)]
    return {"blocks": blocks, "extras": extras}


def init_cache(cfg, batch: int, max_len: int, device=None, n_model: int = 1,
               rank: int = 0, n_data: int = 1, data_rank: int = 0) -> Dict:
    """Stacked decode caches matching the stacked-layer layout (an
    encoder's too: the reference builds them for every arch); over a
    ``(n_data, n_model)`` mesh, zeros of this rank's cut of each leaf
    (:func:`repro_torch.models.parallel.cache_dims`), nothing else
    allocated."""
    if n_model > 1 or n_data > 1:
        from .parallel import cache_shapes, meta_cache

        whole = meta_cache(cfg, batch, max_len)
        shapes = iter(cache_shapes(cfg, batch, max_len, n_model, rank,
                                   n_data, data_rank))
        return tree_map(lambda t: torch.zeros(next(shapes), dtype=t.dtype,
                                              device=device), whole)
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
                tp=None, dp=None, dims=None, seq=None
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
    rank of the group runs the same layers, so the gathers meet.

    ``seq`` (:func:`repro_torch.models.parallel.seq_cut`): the reference's
    sequence-parallel residual stream, ``x`` and ``h`` this rank's slices
    of the sequence over the model group, ``(B, ⌈S/M⌉, D)``, so autograd
    keeps 1/M of each residual boundary; ``positions`` is the whole
    sequence's (attention and the recurrent scans run on the gathered
    whole)."""
    pattern = cfg.layer_pattern
    n_rep, extra_kinds = stack_layout(cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    n_inner = _inner_factor(n_rep) if remat and cfg.remat_sqrt else 1
    save_outs = remat and n_inner == 1 and cfg.remat_save_outs
    dims = dims if dp is not None else None
    layer_dims = _block_dims(dims, dp, pattern)

    def blocks(h, aux, first, last):
        for i in range(first, last):
            for pos, kind in enumerate(pattern):
                h, a = _layer_train(kind, _layer(params["blocks"][pos], i), h,
                                    cfg, positions, save_outs, tp, dp,
                                    layer_dims[pos], seq)
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
                            dims=d, seq=seq)
        aux = aux + a
    return x, aux


def _block_dims(dims, dp, pattern):
    """Per pattern position: one layer's data dims (a stacked leaf's less
    its layer axis), or None."""
    dims = dims if dp is not None else None
    return [None if dims is None else tree_map(lambda d: d - 1, b)
            for b in (dims["blocks"] if dims else pattern)]


def stack_prefill(params: Dict, x: torch.Tensor, cfg, positions, tp=None,
                  dp=None, dims=None, cdims=None, row_cut: bool = True
                  ) -> Tuple[torch.Tensor, Dict]:
    """The stack over the prompt: (h, the decode caches stacked as
    :func:`init_cache` lays them out). ``tp``, ``dp``, ``dims`` as in
    :func:`stack_train`; ``cdims``: the cache's model dims from the end (a
    tree shaped like it, :func:`repro_torch.models.parallel.cache_model_dims`),
    each layer's cache this rank's cut by them; ``row_cut`` as in
    :func:`_ffn_train`."""
    pattern = cfg.layer_pattern
    n_rep, extra_kinds = stack_layout(cfg)
    layer_dims = _block_dims(dims, dp, pattern)
    per_pos: List[List[Dict]] = [[] for _ in pattern]
    for i in range(n_rep):
        for pos, kind in enumerate(pattern):
            x, c = _layer_prefill(kind, _layer(params["blocks"][pos], i), x,
                                  cfg, positions, tp, dp, layer_dims[pos],
                                  cdims and cdims["blocks"][pos], row_cut)
            per_pos[pos].append(c)
    caches = [{k: torch.stack([c[k] for c in cs]) for k in cs[0]}
              if cs else None for cs in per_pos]
    extra_caches = []
    for j, (p_extra, kind) in enumerate(zip(params["extras"], extra_kinds)):
        x, c = _layer_prefill(kind, p_extra, x, cfg, positions, tp, dp,
                              dims["extras"][j] if dims and dp else None,
                              cdims and cdims["extras"][j], row_cut)
        extra_caches.append(c)
    return x, {"blocks": caches, "extras": extra_caches}


def stack_decode(params: Dict, x: torch.Tensor, cache: Dict, cache_pos, cfg,
                 tp=None, dp=None, dims=None, cdims=None, row_cut: bool = True
                 ) -> Tuple[torch.Tensor, Dict]:
    """One token through every layer; each layer's cache is a view of the
    stacked cache and is updated in place, so the returned cache is
    ``cache``. The other arguments as in :func:`stack_prefill`."""
    pattern = cfg.layer_pattern
    n_rep, extra_kinds = stack_layout(cfg)
    layer_dims = _block_dims(dims, dp, pattern)
    for i in range(n_rep):
        for pos, kind in enumerate(pattern):
            x, _ = _layer_decode(kind, _layer(params["blocks"][pos], i), x,
                                 _layer(cache["blocks"][pos], i), cache_pos,
                                 cfg, tp, dp, layer_dims[pos],
                                 cdims and cdims["blocks"][pos], row_cut)
    for j, (p_extra, c_extra, kind) in enumerate(zip(
            params["extras"], cache["extras"], extra_kinds)):
        x, _ = _layer_decode(kind, p_extra, x, c_extra, cache_pos, cfg, tp,
                             dp, dims["extras"][j] if dims and dp else None,
                             cdims and cdims["extras"][j], row_cut)
    return x, cache
