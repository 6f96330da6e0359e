"""AdamW on parameter trees: fp32 moments, global-norm clipping.

Twin of :mod:`repro.optim.adamw`, as plain functions on trees of tensors
(nested dicts and lists): ``init`` builds the state, ``update`` returns new
trees and leaves its arguments as they are, so a caller can compare them
leaf for leaf. Moments are fp32 whatever the parameters' dtype; the weight
update is computed in fp32 and cast back. The clip scale is applied leaf by
leaf inside the update, and each leaf is updated in runs of at most
:data:`CHUNK` elements (element-wise: the same values), so no fp32
temporary of a whole leaf, nor a scaled copy of the whole gradient tree,
exists at once. ``update(..., inplace=True)`` writes the new moments and
parameters into the given ones, as the reference's jitted steps do with
their donated buffers.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.models.transformer import tree_leaves, tree_map, tree_unflatten

# The most elements of a leaf one pass of the update holds fp32 temporaries
# for (256 MB each).
CHUNK = 1 << 26


def init(params: Any) -> Dict[str, Any]:
    """``m`` and ``v`` fp32 zeros like ``params``, and ``count`` an int32 0
    on the parameters' device."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any, sharded: Optional[Sequence[bool]] = None,
                shards=None, data_sliced: Optional[Sequence[bool]] = None,
                data=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, each leaf counted
    once over the whole mesh, as an fp32 scalar. Over a model group
    (``shards``, a :class:`repro_torch.models.parallel.ModelShards`;
    ``sharded[i]``: leaf ``i`` is this rank's model slice) and a data group
    (``data``, a :class:`repro_torch.models.parallel.DataShards`;
    ``data_sliced[i]``: leaf ``i`` is this rank's data slice), a leaf's
    squares are summed over the groups it is cut over, and a whole leaf's
    counted once: every rank gets the whole model's norm.

    The squares are fp32 (the reference's) and their sums accumulate in
    fp64, so the norm rounds to the same fp32 value however the leaves are
    cut (ZeRO-1 slices or whole, any shard count), and every layout clips
    by the same scale; the reference sums in fp32."""
    if shards is None or shards.size == 1:
        sharded = None
    if data is None or data.size == 1:
        data_sliced = None
    parts = {}  # (over model, over data) -> this rank's sum
    for i, x in enumerate(tree_leaves(tree)):
        key = (sharded is not None and sharded[i],
               data_sliced is not None and data_sliced[i])
        sq = torch.sum(torch.square(x.to(torch.float32)), dtype=torch.float64)
        parts[key] = sq if key not in parts else parts[key] + sq
    total = None
    for key in ((False, False), (True, False), (False, True), (True, True)):
        if key not in parts:
            continue
        part = parts[key]
        for over, group in zip(key, (shards, data)):
            if over:
                part = _summed(part, group)
        total = part if total is None else total + part
    return torch.sqrt(total).to(torch.float32)


def _summed(x: torch.Tensor, shards) -> torch.Tensor:
    """``x`` (fp64) summed over ``shards``' group in fp64, counted in its
    stats."""
    import torch.distributed as dist

    x = x.clone()
    dist.all_reduce(x, group=shards.group)
    shards._count(x)
    return x


def update(
    grads: Any,
    state: Dict[str, Any],
    params: Any,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: Optional[float] = 1.0,
    sharded: Optional[Sequence[bool]] = None,
    shards=None,
    data_sliced: Optional[Sequence[bool]] = None,
    data=None,
    inplace: bool = False,
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """Returns (new_params, new_state, {"grad_norm": ...}). Decoupled weight
    decay on matrices only (ndim >= 2). ``sharded``, ``shards``,
    ``data_sliced`` and ``data``: the groups the leaves are cut over
    (:func:`global_norm`); the update itself is element-wise, so each rank
    updates whatever slices it is given (grads, moments and params cut
    alike). ``inplace``: the new moments and parameters are written into
    ``state``'s and ``params``' leaves, which are returned (no second copy
    of the state exists)."""
    gnorm = global_norm(grads, sharded, shards, data_sliced, data)
    scale = None
    if clip_norm is not None:
        scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    count = state["count"] + 1
    cf = count.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                      device=cf.device), cf)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                      device=cf.device), cf)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=cf.device)

    def one(g, m, v, p):
        wd = weight_decay if p.ndim >= 2 else 0.0
        outs = (p, m, v) if inplace else tuple(
            torch.empty_like(t) for t in (p, m, v))
        for r in _runs(tuple(p.shape)):
            gf = g[r].to(torch.float32)
            if scale is not None:  # the reference's g * scale promotes to fp32
                gf = gf * scale
            m_new = b1 * m[r] + (1 - b1) * gf
            v_new = b2 * v[r] + (1 - b2) * gf * gf
            upd = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
            pf = p[r].to(torch.float32)
            p_new = pf - lr * (upd + wd * pf)
            for out, new in zip(outs, (p_new, m_new, v_new)):
                out[r] = new
        return outs

    out = [one(g, m, v, p) for g, m, v, p in zip(
        tree_leaves(grads), tree_leaves(state["m"]), tree_leaves(state["v"]),
        tree_leaves(params))]
    new_params, new_m, new_v = (tree_unflatten(params, col)
                                for col in zip(*out))
    return (new_params, {"m": new_m, "v": new_v, "count": count},
            {"grad_norm": gnorm})


def _runs(shape, lead=()) -> list:
    """Indices that cover a leaf of ``shape`` in runs of at most about
    :data:`CHUNK` elements: row ranges of the first dim whose rows fit,
    each index of the dims before it fixed (the whole leaf when it is
    smaller)."""
    n = math.prod(shape)
    if not shape or n <= CHUNK:
        return [lead + (...,)]
    inner = n // shape[0]
    if inner <= CHUNK or len(shape) == 1:
        rows = max(1, CHUNK // inner)
        return [lead + (slice(i, i + rows),)
                for i in range(0, shape[0], rows)]
    return [r for i in range(shape[0]) for r in _runs(shape[1:], lead + (i,))]
