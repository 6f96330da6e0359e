"""AdamW on parameter trees: fp32 moments, global-norm clipping.

Twin of :mod:`repro.optim.adamw`, as plain functions on trees of tensors
(nested dicts and lists): ``init`` builds the state, ``update`` returns new
trees and leaves its arguments as they are, so a caller can compare them
leaf for leaf. Moments are fp32 whatever the parameters' dtype; the weight
update is computed in fp32 and cast back. The clip scale is applied leaf by
leaf inside the update, so no scaled copy of the whole gradient tree exists
at once.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.models.parallel import reduce_from_model
from repro_torch.models.transformer import tree_leaves, tree_map, tree_unflatten


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
                shards=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's fp32 sum of squares. Over a model
    group (``shards``, a :class:`repro_torch.models.parallel.ModelShards`;
    ``sharded[i]``: leaf ``i`` is this rank's slice), the sliced leaves'
    squares are summed over the group and the replicated leaves' counted
    once: every rank gets the whole model's norm."""
    if shards is None or shards.size == 1:
        sharded = None
    total = part = None
    for i, x in enumerate(tree_leaves(tree)):
        sq = torch.sum(torch.square(x.to(torch.float32)))
        if sharded is not None and sharded[i]:
            part = sq if part is None else part + sq
        else:
            total = sq if total is None else total + sq
    if part is not None:
        part = reduce_from_model(part, shards)
        total = part if total is None else total + part
    return torch.sqrt(total)


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
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """Returns (new_params, new_state, {"grad_norm": ...}). Decoupled weight
    decay on matrices only (ndim >= 2). ``sharded`` and ``shards``: the
    model group the leaves are cut over (:func:`global_norm`); the update
    itself is element-wise, so each rank updates its slices."""
    gnorm = global_norm(grads, sharded, shards)
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
        gf = g.to(torch.float32)
        if scale is not None:  # the reference's g * scale promotes to fp32
            gf = gf * scale
        m_new = b1 * m + (1 - b1) * gf
        v_new = b2 * v + (1 - b2) * gf * gf
        upd = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
        pf = p.to(torch.float32)
        wd = weight_decay if p.ndim >= 2 else 0.0
        p_new = pf - lr * (upd + wd * pf)
        return p_new.to(p.dtype), m_new, v_new

    out = [one(g, m, v, p) for g, m, v, p in zip(
        tree_leaves(grads), tree_leaves(state["m"]), tree_leaves(state["v"]),
        tree_leaves(params))]
    new_params, new_m, new_v = (tree_unflatten(params, col)
                                for col in zip(*out))
    return (new_params, {"m": new_m, "v": new_v, "count": count},
            {"grad_norm": gnorm})
