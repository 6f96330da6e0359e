"""Tensor parallelism over the ``"model"`` mesh axis and parameter
sharding over the ``"data"`` axis: the collectives a sharded training step
needs, with their gradients, and the cut of a parameter tree over both.

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

Over the data axis (the fsdp rules' ``"DP"`` entries) each rank of a model
index holds its slice of the leaves the rules cut there
(:func:`data_dims`), and a layer gathers them whole when it runs:

  gather_from_data   all-gather along a dim forward, reduce-scatter backward

The backward's sum runs in fp32 and is rounded once to the leaf's dtype,
so each microbatch's gradient reaches its rank already reduce-scattered.
:class:`DataShards` is one rank's data group.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.launch import sharding
from repro_torch.launch.mesh import MODEL_AXIS, MeshSpec


def _unflatten(like, leaves):
    it = iter(leaves)
    return sharding.map_with_path(lambda _, __: next(it), like)


class _Shards:
    def __init__(self, group, size: int, rank: int):
        if size < 1 or not 0 <= rank < size:
            raise ValueError(f"rank {rank} of {size}")
        self.group, self.size, self.rank = group, size, rank
        self.stats = {"collectives": 0, "bytes": 0}

    def _count(self, t: torch.Tensor) -> None:
        self.stats["collectives"] += 1
        self.stats["bytes"] += t.numel() * t.element_size()


class ModelShards(_Shards):
    """One rank's model group: ``group`` (a ``torch.distributed`` process
    group of ``size`` ranks) and this rank's index ``rank`` in it.
    ``stats`` counts the collectives the layers issued through it and the
    bytes each rank handed them (forward and backward, recomputes
    included)."""


class DataShards(_Shards):
    """One rank's data group (the ranks of its model index), as
    :class:`ModelShards` is its model group: ``group``, its ``size`` D,
    this rank's data index ``rank`` and ``stats`` (the whole tensor of each
    gather and reduce-scatter)."""


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


def _single(name: str):
    """``torch.distributed``'s one-tensor collective ``name`` (torch 2.13),
    or the ``*_tensor`` name it replaces."""
    import torch.distributed as dist

    return getattr(dist, f"{name}_single", None) or \
        getattr(dist, f"{name}_tensor" if name == "reduce_scatter"
                else f"{name}_into_tensor")


def gather_dim(x: torch.Tensor, dp: _Shards, dim: int) -> torch.Tensor:
    """The group's slices of ``x`` joined along ``dim`` in rank order, in
    ``x``'s dtype (one all-gather, counted in ``dp.stats``)."""
    moved = x.movedim(dim, 0).contiguous()
    out = torch.empty((dp.size * moved.shape[0],) + moved.shape[1:],
                      dtype=x.dtype, device=x.device)
    _single("all_gather")(out, moved, group=dp.group)
    dp._count(out)
    return out.movedim(0, dim)


def reduce_scatter_dim(x: torch.Tensor, dp: _Shards, dim: int,
                       dtype=None) -> torch.Tensor:
    """This rank's slice along ``dim`` of ``x`` summed over the group: the
    sum in fp32 (one reduce-scatter, counted in ``dp.stats``), rounded once
    to ``dtype`` (default ``x``'s)."""
    moved = x.movedim(dim, 0)
    buf = moved
    if moved.dtype != torch.float32 or not moved.is_contiguous():
        buf = torch.empty(moved.shape, dtype=torch.float32, device=x.device)
        buf.copy_(moved)
    out = torch.empty((moved.shape[0] // dp.size,) + moved.shape[1:],
                      dtype=torch.float32, device=x.device)
    _single("reduce_scatter")(out, buf, group=dp.group)
    dp._count(buf)
    return out.movedim(0, dim).to(dtype or x.dtype)


def own_slice(x: torch.Tensor, tp: _Shards, dim: int) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim`` (a contiguous copy, never
    a view: a slice kept in a cache must not hold ``x``'s storage)."""
    n = x.shape[dim] // tp.size
    return x.narrow(dim, tp.rank * n, n).clone(
        memory_format=torch.contiguous_format)


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
        return own_slice(g, ctx.tp, ctx.dim), None, None


class _SliceToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return own_slice(x, tp, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.tp, ctx.dim), None, None


class _GatherFromData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dp, dim):
        ctx.dp, ctx.dim = dp, dim
        return gather_dim(x, dp, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dp, ctx.dim), None, None


def gather_from_data(x: torch.Tensor, dp: Optional[DataShards],
                     dim: Optional[int]) -> torch.Tensor:
    """The data group's slices of a leaf joined along ``dim`` (a whole
    leaf); the gradient is this rank's slice of the group's summed
    gradients (fp32 sum, rounded once to ``x``'s dtype). The identity
    without a data group or a ``dim``."""
    if dp is None or dp.size == 1 or dim is None:
        return x
    return _GatherFromData.apply(x, dp, dim % x.ndim)


def gather_tree(tree, dims, dp: Optional[DataShards]):
    """``tree`` with each leaf whose entry in ``dims`` (a tree of the same
    shape: a dim, or None for a whole leaf) is a dim passed through
    :func:`gather_from_data`."""
    if dp is None or dims is None or tree is None:
        return tree
    if isinstance(tree, dict):
        return {k: gather_tree(v, dims[k], dp) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_tree(v, d, dp) for v, d in zip(tree, dims))
    return gather_from_data(tree, dp, dims)


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
def _outside_modes():
    """A context in which no dispatch mode sees the operators: the meta
    trees below are bookkeeping (their shapes), not the program's
    allocations, which the dry-run's tracker counts."""
    from torch.utils._python_dispatch import _disable_current_modes

    return _disable_current_modes()


@functools.lru_cache(maxsize=None)
def meta_params(cfg):
    """``cfg``'s whole parameter tree on the meta device (nothing is
    allocated; one shared tree per config: read it, do not change it)."""
    from .model import build_model

    with _outside_modes():
        return build_model(cfg, device="meta").init(
            torch.Generator().manual_seed(0))


@functools.lru_cache(maxsize=None)
def meta_cache(cfg, batch: int, max_len: int):
    """The whole decode cache of ``batch`` rows and ``max_len`` positions
    on the meta device (one shared tree: read it, do not change it)."""
    from .transformer import init_cache

    with _outside_modes():
        return init_cache(cfg, batch, max_len, device="meta")


@functools.lru_cache(maxsize=None)
def full_shapes(cfg) -> Tuple[Tuple[str, Tuple[int, ...]], ...]:
    """(keystr, shape) of every leaf of ``cfg``'s whole parameter tree, in
    leaf order."""
    out: List[Tuple[str, Tuple[int, ...]]] = []
    sharding.map_with_path(
        lambda path, t: out.append((sharding.keystr(path), tuple(t.shape))),
        meta_params(cfg))
    return tuple(out)


def model_dims(cfg, n_model: int) -> List[Optional[int]]:
    """Per leaf of ``cfg``'s parameter tree (in leaf order):
    the dim cut over ``n_model`` model shards, or None for a whole leaf
    (replicated, or a dim the divisibility guard keeps whole)."""
    mesh = MeshSpec((1, n_model), ("data", MODEL_AXIS))
    return [sharding.model_dim(sharding.spec_for_param(key, shape, cfg, mesh))
            if n_model > 1 else None
            for key, shape in full_shapes(cfg)]


@functools.lru_cache(maxsize=None)
def data_dims(cfg, n_data: int, n_model: int = 1, moments: bool = False
              ) -> Tuple[Optional[int], ...]:
    """Per leaf of ``cfg``'s parameter tree (in leaf order), on a
    ``(n_data, n_model)`` mesh: the dim cut over the data axis, or None.
    For parameters, the rules' ``"DP"`` entries (only ``fsdp`` mode has
    any); with ``moments``, the AdamW moments' cut by
    :func:`repro_torch.launch.sharding.opt_shardings` (ZeRO-1: in either
    mode, the first still-whole dim the data axis divides, the stacked
    layer axis included)."""
    if n_data == 1:
        return (None,) * len(full_shapes(cfg))
    mesh = MeshSpec((n_data, n_model), ("data", MODEL_AXIS))
    specs = [sharding.spec_for_param(key, shape, cfg, mesh)
             for key, shape in full_shapes(cfg)]
    if moments:
        specs = sharding.opt_shardings(specs, mesh, [
            torch.empty(shape, device="meta")
            for _, shape in full_shapes(cfg)])["m"]
    return tuple(sharding.data_dim(spec) for spec in specs)


def data_dims_tree(cfg, n_data: int, n_model: int = 1) -> Any:
    """:func:`data_dims` of the parameters as a tree shaped like them."""
    it = iter(data_dims(cfg, n_data, n_model))
    return sharding.map_with_path(lambda _, __: next(it), meta_params(cfg))


def _narrow(t: torch.Tensor, dim: Optional[int], n: int, rank: int
            ) -> torch.Tensor:
    if dim is None or n == 1:
        return t
    k = t.shape[dim] // n
    return t.narrow(dim, rank * k, k)


def shard_params(full_tree: Any, cfg, n_model: int, rank: int,
                 n_data: int = 1, data_rank: int = 0,
                 moments: bool = False) -> Any:
    """Model shard ``rank`` of ``n_model`` and data slice ``data_rank`` of
    ``n_data`` of a whole parameter-shaped tree: each leaf cut along its
    ``"model"`` dim and its data dim (:func:`data_dims`; ``moments``: an
    AdamW moment's under ZeRO-1), a contiguous copy; the other leaves as
    they are."""
    dims = model_dims(cfg, n_model)
    ddims = data_dims(cfg, n_data, n_model, moments)
    leaves = sharding.leaves(full_tree)
    if len(leaves) != len(dims):
        raise ValueError(f"{len(leaves)} leaves for a tree of {len(dims)}")
    out = []
    for t, d, e in zip(leaves, dims, ddims):
        if d is None and e is None:
            out.append(t)
            continue
        t = _narrow(_narrow(t, d, n_model, rank), e, n_data, data_rank)
        out.append(t.clone())
    return _unflatten(full_tree, out)


def cut_over_data(local_tree: Any, cfg, n_model: int, dp: DataShards
                  ) -> Any:
    """``dp``'s slice of one model shard's tree (of ``n_model``): each leaf
    the rules cut over data (:func:`data_dims`) narrowed along that dim, a
    contiguous copy; the other leaves as they are."""
    out = [t if e is None else _narrow(t, e, dp.size, dp.rank).clone()
           for t, e in zip(sharding.leaves(local_tree),
                           data_dims(cfg, dp.size, n_model))]
    return _unflatten(local_tree, out)


def local_shapes(cfg, n_model: int) -> List[Tuple[int, ...]]:
    """Each leaf's shape on one model shard of ``n_model``, whole over
    data."""
    out = []
    for (_, shape), d in zip(full_shapes(cfg), model_dims(cfg, n_model)):
        shape = list(shape)
        if d is not None:
            shape[d] //= n_model
        out.append(tuple(shape))
    return out


def data_cut_dims(tree: Any, cfg, n_model: int, n_data: int
                  ) -> List[Optional[int]]:
    """Per leaf of a tree of one model shard's leaves: the dim along which
    it holds a 1/``n_data`` slice (read from its shape against the
    shard's whole leaf), or None where it is whole. Raises on any other
    shape. So a parameter tree and its moments may rest cut alike (the
    fsdp placement) or differently (ZeRO-1)."""
    out = []
    for t, want in zip(sharding.leaves(tree), local_shapes(cfg, n_model)):
        got = tuple(t.shape)
        off = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        if len(got) != len(want) or len(off) > 1 or (
                off and got[off[0]] * n_data != want[off[0]]):
            raise ValueError(f"a leaf of shape {got} is no 1/{n_data} slice "
                             f"of {want}")
        out.append(off[0] if off else None)
    return out


def unshard_params(local_tree: Any, cfg, tp: Optional[ModelShards],
                   device=None, dp: Optional[DataShards] = None) -> Any:
    """The whole tree from every shard's ``local_tree`` (every rank of the
    groups calls this): each leaf cut over data (``dp``; the dim read from
    its shape, :func:`data_cut_dims`) all-gathered along it, then each cut
    over model along its ``"model"`` dim, one leaf at a time, and moved to
    ``device`` (default: where it is). The gathers are not counted in the
    groups' stats."""
    import torch.distributed as dist

    leaves = sharding.leaves(local_tree)
    n_model = 1 if tp is None else tp.size
    dims = model_dims(cfg, n_model)
    ddims = ([None] * len(dims) if dp is None or dp.size == 1
             else data_cut_dims(local_tree, cfg, n_model, dp.size))
    out = []
    for t, d, e in zip(leaves, dims, ddims):
        for cut, shards in ((e, dp), (d, tp)):
            if cut is not None:
                parts = [torch.empty_like(t) for _ in range(shards.size)]
                dist.all_gather(parts, t.contiguous(), group=shards.group)
                t = torch.cat(parts, dim=cut)
        out.append(t if device is None else t.to(device))
    return _unflatten(local_tree, out)


def cut_like(whole_tree: Any, like: Any, cfg, tp: Optional[ModelShards],
             dp: Optional[DataShards] = None) -> Any:
    """This rank's cut of a whole tree, each leaf cut as the same leaf of
    ``like`` (one shard's tree) is: along its ``"model"`` dim, and along
    the data dim its shape shows (:func:`data_cut_dims`); contiguous
    copies on ``like``'s devices."""
    n_model = 1 if tp is None else tp.size
    dims = model_dims(cfg, n_model)
    ddims = ([None] * len(dims) if dp is None or dp.size == 1
             else data_cut_dims(like, cfg, n_model, dp.size))
    out = []
    for t, proto, d, e in zip(sharding.leaves(whole_tree),
                              sharding.leaves(like), dims, ddims):
        if d is not None:
            t = _narrow(t, d, n_model, tp.rank)
        if e is not None:
            t = _narrow(t, e, dp.size, dp.rank)
        out.append(t.contiguous().to(proto.device))
    return _unflatten(like, out)


def sharded_leaves(cfg, tp: Optional[ModelShards]) -> List[bool]:
    """Per leaf: whether each model shard holds only its slice of it."""
    return [d is not None
            for d in model_dims(cfg, 1 if tp is None else tp.size)]


# ---------------------------------------------------------------------- #
# Drawing a cut tree without its whole leaves
# ---------------------------------------------------------------------- #
class Box(NamedTuple):
    """This rank's part of one whole leaf: its first index and its extent
    along each dim of the whole ``shape``."""

    shape: Tuple[int, ...]
    lo: Tuple[int, ...]
    size: Tuple[int, ...]

    @property
    def whole(self) -> bool:
        return self.size == self.shape


class InitCut:
    """This rank's cut of a parameter tree (:func:`init_cut`), for ``init``
    to allocate each leaf's slice and keep its elements of every draw
    (:func:`repro_torch.models.layers.normal_`). ``at(*keys)`` is the cut
    below a path of the tree; at a leaf, ``box()`` its :class:`Box` and
    ``local(shape)`` the slice's shape."""

    def __init__(self, boxes, path: Tuple = ()):
        self.path, self._boxes = tuple(path), boxes

    def at(self, *keys) -> "InitCut":
        return InitCut(self._boxes, self.path + keys)

    def box(self) -> Box:
        return self._boxes[sharding.keystr(self.path)]

    def local(self, shape) -> Tuple[int, ...]:
        box = self.box()
        if tuple(shape) != box.shape:
            raise ValueError(f"{sharding.keystr(self.path)}: a leaf of "
                             f"{tuple(shape)}, the tree's is {box.shape}")
        return box.size

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a small whole leaf ``t`` (a copy)."""
        box = self.box()
        for dim, (lo, n) in enumerate(zip(box.lo, box.size)):
            t = t.narrow(dim, lo, n)
        return t.clone()


def init_cut(cfg, n_model: int, rank: int, n_data: int = 1,
             data_rank: int = 0) -> InitCut:
    """The :class:`InitCut` of model shard ``rank`` of ``n_model`` and data
    slice ``data_rank`` of ``n_data`` of ``cfg``'s tree, as
    :func:`shard_params` cuts it."""
    boxes = {}
    for (key, shape), d, e in zip(full_shapes(cfg), model_dims(cfg, n_model),
                                  data_dims(cfg, n_data, n_model)):
        lo, size = [0] * len(shape), list(shape)
        for dim, n, r in ((d, n_model, rank), (e, n_data, data_rank)):
            if dim is not None and n > 1:
                size[dim] //= n
                lo[dim] += r * size[dim]
        boxes[key] = Box(shape, tuple(lo), tuple(size))
    return InitCut(boxes)


def at(cut: Optional[InitCut], *keys) -> Optional[InitCut]:
    """``cut.at(*keys)``, or None for a whole tree."""
    return None if cut is None else cut.at(*keys)


def row_runs(box: Box) -> List[Tuple[int, int, int]]:
    """The rows of ``box.shape`` viewed as (rows, last dim) that the box
    keeps, as maximal runs (first whole row, rows, first local row) in
    order: each run a contiguous block of the whole leaf's rows, landing
    on contiguous rows of the slice."""
    dims, lo, size = box.shape[:-1], box.lo[:-1], box.size[:-1]
    cut = [i for i in range(len(dims)) if size[i] != dims[i]]
    if not cut:
        return [(0, math.prod(dims), 0)]
    t = cut[-1]
    inner = math.prod(dims[t + 1:])
    runs, local = [], 0
    for idx in itertools.product(*(range(lo[i], lo[i] + size[i])
                                   for i in range(t))):
        g = 0
        for i, v in enumerate(idx):
            g = g * dims[i] + v
        runs.append(((g * dims[t] + lo[t]) * inner, size[t] * inner, local))
        local += size[t] * inner
    return runs


# ---------------------------------------------------------------------- #
# Cutting decode caches
# ---------------------------------------------------------------------- #
def _cache_dims_of(tree, cfg, n_model: int, n_data: int
                   ) -> Tuple[Tuple[Optional[int], Optional[int]], ...]:
    mesh = MeshSpec((n_data, n_model), ("data", MODEL_AXIS))
    specs = sharding.leaves(sharding.cache_shardings(tree, cfg, mesh))
    return tuple((sharding.model_dim(s) if n_model > 1 else None,
                  sharding.data_dim(s) if n_data > 1 else None)
                 for s in specs)


@functools.lru_cache(maxsize=None)
def cache_dims(cfg, batch: int, max_len: int, n_model: int, n_data: int = 1
               ) -> Tuple[Tuple[Optional[int], Optional[int]], ...]:
    """Per leaf of ``init_cache(cfg, batch, max_len)`` (in leaf order, a
    stacked leaf's dims counting its layer axis): (the dim
    :func:`repro_torch.launch.sharding.cache_shardings` cuts over
    ``n_model`` model shards, the dim it cuts over ``n_data`` data
    indices), None where it keeps the leaf whole. A K/V leaf's slots go
    over the model axis when ``slots % M == 0 and slots >= 4M``, else its
    heads, else its head dim; an ssm ``state`` its heads, a ``conv`` or an
    rglru ``h`` its channels; the batch rows over data when they divide."""
    return _cache_dims_of(meta_cache(cfg, batch, max_len), cfg, n_model,
                          n_data)


def cache_model_dims(cfg, batch: int, max_len: int, n_model: int) -> Any:
    """The model dim of each leaf of :func:`cache_dims` counted from the
    end (so it holds for one layer's view of a stacked leaf too), as a
    tree shaped like the cache; None where whole."""
    from .transformer import tree_unflatten

    whole = meta_cache(cfg, batch, max_len)
    dims = [None if d is None else d - t.ndim
            for (d, _), t in zip(cache_dims(cfg, batch, max_len, n_model),
                                 _leaves(whole))]
    return tree_unflatten(whole, dims)


def _leaves(tree):
    from .transformer import tree_leaves

    return tree_leaves(tree)


def cache_shapes(cfg, batch: int, max_len: int, n_model: int = 1,
                 rank: int = 0, n_data: int = 1, data_rank: int = 0
                 ) -> List[Tuple[int, ...]]:
    """Each cache leaf's shape on model shard ``rank`` and data index
    ``data_rank`` (:func:`cache_dims`)."""
    out = []
    for t, (d, e) in zip(_leaves(meta_cache(cfg, batch, max_len)),
                         cache_dims(cfg, batch, max_len, n_model, n_data)):
        shape = list(t.shape)
        for dim, n in ((d, n_model), (e, n_data)):
            if dim is not None:
                shape[dim] //= n
        out.append(tuple(shape))
    return out


def shard_cache(cache: Any, cfg, n_model: int, rank: int, n_data: int = 1,
                data_rank: int = 0) -> Any:
    """Model shard ``rank`` and data index ``data_rank`` of a whole decode
    cache (each leaf cut by the reference's ``cache_shardings`` rule for
    its shape; contiguous copies)."""
    from .transformer import tree_unflatten

    leaves = _leaves(cache)
    out = [_narrow(_narrow(t, d, n_model, rank), e, n_data,
                   data_rank).contiguous()
           for t, (d, e) in zip(leaves, _cache_dims_of(
               cache, cfg, n_model, n_data))]
    return tree_unflatten(cache, out)


def unshard_cache(cache: Any, cfg, batch: int, max_len: int,
                  tp: Optional[ModelShards], dp: Optional[DataShards] = None
                  ) -> Any:
    """The whole ``(batch, max_len)`` decode cache from every rank's cut
    (every rank of the groups calls this; the gathers are not counted)."""
    import torch.distributed as dist

    from .transformer import tree_unflatten

    n_model = 1 if tp is None else tp.size
    n_data = 1 if dp is None else dp.size
    out = []
    for t, (d, e) in zip(_leaves(cache), cache_dims(cfg, batch, max_len,
                                                    n_model, n_data)):
        for cut, shards in ((e, dp), (d, tp)):
            if cut is not None:
                parts = [torch.empty_like(t) for _ in range(shards.size)]
                dist.all_gather(parts, t.contiguous(), group=shards.group)
                t = torch.cat(parts, dim=cut)
        out.append(t)
    return tree_unflatten(cache, out)


def own_rows(n: int, dp: Optional[DataShards]) -> Optional[slice]:
    """The rows of a batch of ``n`` this data index serves: its 1/D when D
    divides ``n`` (the reference's ``batch_shardings``), else None (every
    data index serves every row)."""
    if dp is None or dp.size == 1 or n % dp.size:
        return None
    k = n // dp.size
    return slice(dp.rank * k, (dp.rank + 1) * k)
