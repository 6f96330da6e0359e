"""Tensor parallelism over the ``"model"`` mesh axis: the collectives a
sharded training step needs, with their gradients, and the cut of a
parameter tree into model shards.

The reference never writes these: it places each parameter by
:mod:`repro_torch.launch.sharding`'s rules and GSPMD inserts every gather
and reduction. Here each rank of a model group holds its slice of every
leaf whose spec puts a dim on ``"model"``, and the layers (attention, MLP,
MoE, RG-LRU, SSD, the embedding and the loss) call four autograd functions
at the edges of their sharded regions (Megatron-LM's scheme):

  copy_to_model      identity forward, all-reduce (sum) backward
  reduce_from_model  all-reduce (sum) forward, identity backward
  gather_from_model  all-gather along a dim forward, own slice backward
  slice_to_model     own slice forward, all-gather along the dim backward

The loss is computed whole on every rank of a model group, so the gradient
of every replicated tensor is the whole gradient on each rank; a sharded
region's input passes through ``copy_to_model`` (each rank's branch adds
only its columns' part) and its output through ``reduce_from_model``.
(``torch.distributed.nn.functional.all_reduce`` is not used: its backward
all-reduces too, which would multiply every gradient by M.) Sums travel in
fp32 whatever the tensor's dtype, and each result is rounded once to it.

:class:`ModelShards` is one rank's model group; ``None`` in its place
means one shard, and every function here is then the identity.
"""

from __future__ import annotations

import functools
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.launch import sharding
from repro_torch.launch.mesh import MODEL_AXIS, MeshSpec


def _unflatten(like, leaves):
    it = iter(leaves)
    return sharding.map_with_path(lambda _, __: next(it), like)


class ModelShards:
    """One rank's model group: ``group`` (a ``torch.distributed`` process
    group of ``size`` ranks) and this rank's index ``rank`` in it.
    ``stats`` counts the collectives the layers issued through it and the
    bytes each rank handed them (forward and backward, recomputes
    included)."""

    def __init__(self, group, size: int, rank: int):
        if size < 1 or not 0 <= rank < size:
            raise ValueError(f"model rank {rank} of {size}")
        self.group, self.size, self.rank = group, size, rank
        self.stats = {"collectives": 0, "bytes": 0}

    def _count(self, t: torch.Tensor) -> None:
        self.stats["collectives"] += 1
        self.stats["bytes"] += t.numel() * t.element_size()


def over(tp: Optional[ModelShards], local: int, full: int
         ) -> Optional[ModelShards]:
    """``tp`` when a dim of ``full`` entries is split into ``local``-entry
    slices, else None (whole: one shard, or a dim the guard kept whole)."""
    if tp is None or tp.size == 1 or local == full:
        return None
    if local * tp.size != full:
        raise ValueError(f"a slice of {local} is no 1/{tp.size} of {full}")
    return tp


def _all_reduce(x: torch.Tensor, tp: ModelShards, op=None) -> torch.Tensor:
    """A new tensor: ``x`` summed (or reduced by ``op``) over the model
    group in fp32, rounded once to ``x``'s dtype."""
    import torch.distributed as dist

    buf = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    buf.copy_(x)
    dist.all_reduce(buf, op=op or dist.ReduceOp.SUM, group=tp.group)
    tp._count(buf)
    return buf.to(x.dtype)


def _all_gather(x: torch.Tensor, tp: ModelShards, dim: int) -> torch.Tensor:
    import torch.distributed as dist

    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(tp.size)]
    dist.all_gather(parts, x, group=tp.group)
    out = torch.cat(parts, dim=dim)
    tp._count(out)
    return out


def _own(x: torch.Tensor, tp: ModelShards, dim: int) -> torch.Tensor:
    n = x.shape[dim] // tp.size
    return x.narrow(dim, tp.rank * n, n).contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _all_gather(x, tp, dim)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.tp, ctx.dim), None, None


class _SliceToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _own(x, tp, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.tp, ctx.dim), None, None


def copy_to_model(x: torch.Tensor, tp: Optional[ModelShards]) -> torch.Tensor:
    """Enter a sharded region: identity, and the gradient all-reduced."""
    return x if tp is None else _CopyToModel.apply(x, tp)


def reduce_from_model(x: torch.Tensor, tp: Optional[ModelShards]) -> torch.Tensor:
    """Leave a sharded region: the ranks' partial results summed (in fp32);
    the gradient passes through."""
    return x if tp is None else _ReduceFromModel.apply(x, tp)


def gather_from_model(x: torch.Tensor, tp: Optional[ModelShards],
                      dim: int = -1) -> torch.Tensor:
    """The ranks' slices joined along ``dim`` (rank order); the gradient is
    this rank's slice of the whole one."""
    return x if tp is None else _GatherFromModel.apply(x, tp, dim % x.ndim)


def slice_to_model(x: torch.Tensor, tp: Optional[ModelShards],
                   dim: int = -1) -> torch.Tensor:
    """This rank's slice of a replicated tensor along ``dim``; the gradient
    is the ranks' slices joined."""
    return x if tp is None else _SliceToModel.apply(x, tp, dim % x.ndim)


def max_over_model(x: torch.Tensor, tp: Optional[ModelShards]) -> torch.Tensor:
    """The element-wise maximum over the model group, no gradient."""
    import torch.distributed as dist

    if tp is None:
        return x
    return _all_reduce(x.detach(), tp, dist.ReduceOp.MAX)


def finish(parts: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]],
           tp: Optional[ModelShards]) -> torch.Tensor:
    """A sublayer's output from its (partial, whole) parts: the ranks'
    partial sums reduced, plus what every rank computed whole."""
    partial, whole = parts
    if partial is None:
        return whole
    out = reduce_from_model(partial, tp)
    return out if whole is None else out + whole


# ---------------------------------------------------------------------- #
# Cutting and joining parameter trees
# ---------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _full_shapes(cfg) -> Tuple[Tuple[str, Tuple[int, ...]], ...]:
    """(keystr, shape) of every leaf of ``cfg``'s whole parameter tree, in
    leaf order (built on the meta device: nothing is
    allocated)."""
    from .model import build_model

    params = build_model(cfg, device="meta").init(
        torch.Generator().manual_seed(0))
    out: List[Tuple[str, Tuple[int, ...]]] = []
    sharding.map_with_path(
        lambda path, t: out.append((sharding.keystr(path), tuple(t.shape))),
        params)
    return tuple(out)


def model_dims(cfg, n_model: int) -> List[Optional[int]]:
    """Per leaf of ``cfg``'s parameter tree (in leaf order):
    the dim cut over ``n_model`` model shards, or None for a whole leaf
    (replicated, or a dim the divisibility guard keeps whole)."""
    mesh = MeshSpec((1, n_model), ("data", MODEL_AXIS))
    return [sharding.model_dim(sharding.spec_for_param(key, shape, cfg, mesh))
            if n_model > 1 else None
            for key, shape in _full_shapes(cfg)]


def shard_params(full_tree: Any, cfg, n_model: int, rank: int) -> Any:
    """Model shard ``rank`` of ``n_model`` of a whole parameter-shaped tree
    (params, or an AdamW moment): each leaf cut along its ``"model"`` dim
    (a contiguous copy), the other leaves as they are."""
    dims = model_dims(cfg, n_model)
    leaves = sharding.leaves(full_tree)
    if len(leaves) != len(dims):
        raise ValueError(f"{len(leaves)} leaves for a tree of {len(dims)}")
    out = []
    for t, d in zip(leaves, dims):
        if d is None:
            out.append(t)
            continue
        n = t.shape[d] // n_model
        out.append(t.narrow(d, rank * n, n).clone())
    return _unflatten(full_tree, out)


def unshard_params(local_tree: Any, cfg, tp: Optional[ModelShards],
                   device=None) -> Any:
    """The whole tree from every model shard's ``local_tree`` (every rank
    of the group calls this): each cut leaf all-gathered along its dim,
    one leaf at a time, and moved to ``device`` (default: where it is).
    The gathers are not counted in ``tp.stats``."""
    import torch.distributed as dist

    leaves = sharding.leaves(local_tree)
    dims = model_dims(cfg, 1 if tp is None else tp.size)
    out = []
    for t, d in zip(leaves, dims):
        if d is not None:
            parts = [torch.empty_like(t) for _ in range(tp.size)]
            dist.all_gather(parts, t.contiguous(), group=tp.group)
            t = torch.cat(parts, dim=d)
        out.append(t if device is None else t.to(device))
    return _unflatten(local_tree, out)


def sharded_leaves(cfg, tp: Optional[ModelShards]) -> List[bool]:
    """Per leaf: whether each model shard holds only its slice of it."""
    return [d is not None
            for d in model_dims(cfg, 1 if tp is None else tp.size)]
