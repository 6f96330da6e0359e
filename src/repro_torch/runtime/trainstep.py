"""Train-step factories: the paper's technique as a training mode.

Twin of :mod:`repro.runtime.trainstep`. The reference runs its workers as
one SPMD program, ``shard_map`` manual over the mesh's data axis; here they
run on one process, or over the ranks of a ``torch.distributed`` group
(:func:`repro_torch.launch.mesh.make_worker_mesh`), each data index a
contiguous run of them (:func:`repro_torch.launch.mesh.workers_of`). With
model shards (the mesh's ``"model"`` dim, the bundle's ``shards``) each
worker's model is split over the M ranks of a data index, which run the
same micro-steps tensor-parallel (:mod:`repro_torch.models.parallel`); the
reference gets the same from GSPMD (its ``grad_shardings``).

usec mode (:func:`make_usec_train_step`)
    every worker runs ITS OWN number of micro-steps (its plan entry) over
    its staged (uncoded, J-replicated) tiles, weighting each tile's
    gradient by the plan's inclusion mask (straggler-redundancy dedup).
    As in the reference, each worker accumulates in ``cfg.grad_accum_dtype``
    and the workers' sums meet in fp32 (bf16 accumulation per worker, an
    fp32 reduce); one per-worker buffer is reused, so a bf16 model holds
    one bf16 accumulator and one fp32 total whatever the worker count. The
    single synchronization point, the paper's "master combine", is one
    all-reduce of the fp32 totals with the NLL and token sums, packed into
    a few flat buffers (the reference's ``psum``), over the data group: a
    model shard's gradients are already whole for its slice. Optional int8
    + error-feedback compression replaces the fp32 sum (:mod:`.compression`).
    Then the sum is divided by the token count and AdamW updates the
    parameters, identically on every rank of a data group; the gradient
    norm spans the mesh. With ZeRO-1 (``reduced_grad_shardings``) the
    totals of the leaves whose moments are cut over data are reduce-
    scattered instead, AdamW updates each rank's slices with moments held
    only as slices, and the updated slices are all-gathered back.

fsdp mode (:func:`make_fsdp_train_step`)
    the reference's GSPMD step: fp32 gradient accumulation over global
    microbatches, USEC ownership entering as per-sample weights. Over a
    data group the parameters rest cut over (data, model) by the fsdp
    rules and the moments by ZeRO-1; each rank runs its rows of every
    microbatch, its layers gather their leaves as they run, and each
    micro-step's gradient reaches the rank's total reduce-scattered.

The reference's ``worker_axes`` (pure DP: every chip a worker) is this
step over a one-dim data group of every rank, one worker a rank, no model
shards (:mod:`repro_torch.launch.dryrun`'s dp cells); its
``grad_shardings`` is what the model shards do.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch import sharding
from repro_torch.launch.mesh import workers_of
from repro_torch.models.layers import dtype_of
from repro_torch.models.parallel import (
    DataShards,
    data_cut_dims,
    data_dims,
    gather_dim,
    model_dims,
    own_slice,
    reduce_scatter_dim,
    sharded_leaves,
)
from repro_torch.models.transformer import tree_leaves, tree_unflatten
from repro_torch.optim import adamw

from .compression import CompressedSum, flat_buckets


def value_and_grad(loss_fn: Callable, params: Any, batch: Dict
                   ) -> Tuple[torch.Tensor, Dict, list]:
    """``jax.value_and_grad(loss_fn, has_aux=True)`` with autograd:
    (loss, metrics, gradient leaves in :func:`tree_leaves` order). The
    caller's tensors are not touched: the graph starts at detached aliases
    of them. A parameter the loss does not use gets a zero gradient, as in
    JAX."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


class _DataAxis:
    """Where each leaf of a step's parameters rests over the data group
    ``dp``: ``rest[i]``, the dim its parameter is cut along, and ``cut[i]``,
    the dim its moments and its reduced gradient are cut along (by default
    as the parameter rests); None for whole. ``dp`` issues the step's
    data-group collectives."""

    def __init__(self, dp: Optional[DataShards], rest, cut=None):
        self.dp, self.rest = dp, list(rest)
        self.cut = self.rest if cut is None else list(cut)
        if len(self.cut) != len(self.rest):
            raise ValueError(f"{len(self.cut)} moment specs for "
                             f"{len(self.rest)} leaves")
        for i, (r, c) in enumerate(zip(self.rest, self.cut)):
            if r is not None and r != c:
                raise ValueError(f"leaf {i} rests cut on dim {r} but its "
                                 f"moments on {c}")
        if dp is None and any(c is not None for c in self.cut):
            raise ValueError("moments cut over data need the data group")

    def whole(self, leaves):
        """The parameter leaves whole over the data group (gathered)."""
        return [p if d is None else gather_dim(p, self.dp, d).contiguous()
                for p, d in zip(leaves, self.rest)]

    def slices(self, leaves):
        """The parameter leaves the update sees: each cut as its moments."""
        return [p if r is not None or c is None else own_slice(p, self.dp, c)
                for p, r, c in zip(leaves, self.rest, self.cut)]

    def rejoin(self, leaves):
        """Updated slices back to where the parameters rest."""
        return [p if r is not None or c is None
                else gather_dim(p, self.dp, c).contiguous()
                for p, r, c in zip(leaves, self.rest, self.cut)]

    def sliced(self):
        return [c is not None for c in self.cut]


def _moment_dims(reduced_grad_shardings):
    if reduced_grad_shardings is None:
        return None
    return [sharding.data_dim(spec)
            for spec in sharding.leaves(reduced_grad_shardings)]


def _group_rank(group) -> Tuple[int, int]:
    if group is None:
        return 0, 1
    import torch.distributed as dist

    return dist.get_rank(group), dist.get_world_size(group)


def _all_reduce(bufs, group, stats) -> None:
    import torch.distributed as dist

    for buf in bufs:
        dist.all_reduce(buf, group=group)
    stats["collectives"] += len(bufs)
    stats["bytes"] += sum(b.numel() * b.element_size() for b in bufs)


def make_usec_train_step(bundle, t_stage: int, b_max: int,
                         compress_grads: bool = False, group=None,
                         static_trips: Optional[int] = None,
                         reduced_grad_shardings=None):
    """USEC (uneven-loop) train step on the bundle's device. The caller
    passes each step's ``lr`` (the reference's unused ``peak_lr`` is gone).

    step(params, opt_state, comp_state, staged, mb_slot, mb_inc, n_mb, lr)
      staged:  schema dict, each (N, T_stage, mb, ...)
      mb_slot: (N, B_max) int   — staged slot per micro-step
      mb_inc:  (N, B_max) float — inclusion weight (0 = redundant copy)
      n_mb:    (N, 1) int       — per-worker trip count
    returns (new_params, new_opt_state, new_comp_state, metrics) with
    metrics ``loss`` (the included tokens' mean NLL + aux term),
    ``n_tokens`` and ``grad_norm``. ``t_stage`` and ``b_max`` are the
    staged and padded list widths the arrays must have.

    ``group``: a ``torch.distributed`` process group over the data indices
    (a worker mesh's ``"data"`` group,
    :func:`repro_torch.launch.mesh.data_group`; every rank passes the same
    N-worker arrays, and runs only its own rows, ``workers_of(rank)``), or
    None for all N on this process. With model shards the
    parameters and optimizer state are this rank's slices (the bundle's
    ``init`` cut) and ``bundle.shards`` is its model group. With
    compression, ``comp_state``'s ``ef`` rows are this process's workers
    (their slices, whole over data). Every rank returns the same metrics,
    and the ranks of a data group the same parameters.

    ``reduced_grad_shardings``: ZeRO-1, the reference's argument: a
    params-shaped tree of specs over the data axis, the moments' cut
    (:func:`repro_torch.launch.sharding.opt_shardings` ``["m"]``). Each
    rank's ``opt_state`` then holds only its slices of ``m`` and ``v``; the
    fp32 totals of those leaves are reduce-scattered over ``group`` (a
    compressed sum keeps its slice of the exact sum), AdamW updates the
    slices and the updated parameters are all-gathered, in their dtype.

    Parameters (and their moments) may rest cut over the data group, as
    the trainer places the fsdp rules' leaves
    (:func:`repro_torch.models.parallel.cut_over_data`; which leaves, and
    along which dim, is read from their shapes,
    :func:`repro_torch.models.parallel.data_cut_dims`): the step gathers
    them once at its start (the workers' uneven loops must issue no
    per-layer collective) and reduce-scatters their totals. The bundle
    carries no data shards.

    ``static_trips``: run exactly that many micro-steps per worker, ignoring
    ``n_mb`` (the reference's cost-analysis variant; padded entries carry
    weight 0).

    ``step.stats`` counts the collectives the step issued over the data
    group and their bytes, over all calls (the model group's are in
    ``bundle.shards.stats``).
    """
    cfg, device, loss_fn = bundle.cfg, bundle.device, bundle.loss_fn
    shards = bundle.shards
    if bundle.data is not None:
        raise ValueError("the usec step gathers whole leaves itself: build "
                         "its bundle without data shards")
    n_model = 1 if shards is None else shards.size
    sharded = None if shards is None else sharded_leaves(cfg, shards)
    acc_dtype = dtype_of(getattr(cfg, "grad_accum_dtype", "float32"))
    rank, world = _group_rank(group)
    if static_trips is not None and not 0 <= static_trips <= b_max:
        raise ValueError(f"static_trips {static_trips} outside [0, {b_max}]")
    stats = {"collectives": 0, "bytes": 0}
    dp = None
    if group is not None:
        dp = DataShards(group, world, rank)
        dp.stats = stats
    moment_dims = _moment_dims(reduced_grad_shardings)
    uncut = [None] * len(model_dims(cfg, n_model))
    _DataAxis(dp, uncut, moment_dims)  # fails here, not at the first step

    def step(params, opt_state, comp_state, staged, mb_slot, mb_inc, n_mb,
             lr):
        mb_slot = np.asarray(mb_slot)
        n_workers = mb_slot.shape[0]
        mine = workers_of(rank, world, n_workers)
        rows = slice(mine.start, mine.stop)
        staged = {k: torch.as_tensor(v[rows], device=device)
                  for k, v in staged.items()}
        mb_slot = mb_slot[rows]
        inc = torch.as_tensor(mb_inc[rows], device=device).to(torch.float32)
        n_mb = np.asarray(n_mb).reshape(-1)[rows]
        widths = {a.shape[1] for a in staged.values()}
        if widths != {t_stage} or mb_slot.shape[1] != b_max:
            raise ValueError(f"staged widths {widths} and list width "
                             f"{mb_slot.shape[1]}; the step was built for "
                             f"{t_stage} and {b_max}")
        axis = _DataAxis(dp, uncut if dp is None else data_cut_dims(
            params, cfg, n_model, world), moment_dims)
        plist = axis.whole(tree_leaves(params))
        work = tree_unflatten(params, plist)
        acc = [torch.empty(p.shape, dtype=acc_dtype, device=device)
               for p in plist]
        # This process's NLL and token sums. The fp32 totals (or the
        # compressed sum) are allocated after the first worker's micro-steps,
        # not beside their activations.
        sums = torch.zeros(2, dtype=torch.float32, device=device)
        bufs = total = summed = None
        for i in range(len(mine)):
            for a in acc:
                a.zero_()
            nll_w = torch.zeros((), dtype=torch.float32, device=device)
            ntok_w = torch.zeros((), dtype=torch.float32, device=device)
            trips = static_trips if static_trips is not None else int(n_mb[i])
            for j in range(trips):
                slot = int(mb_slot[i, j])
                batch = {k: v[i, slot] for k, v in staged.items()}
                loss_j, metrics, grads = value_and_grad(loss_fn, work, batch)
                wt = inc[i, j]
                for a, g in zip(acc, grads):
                    a += (wt * g.to(torch.float32)).to(acc_dtype)
                del grads
                nll_w = nll_w + wt * loss_j
                ntok_w = ntok_w + wt * metrics["n_tokens"]
            sums[0] += nll_w
            sums[1] += ntok_w
            if compress_grads:
                if summed is None:
                    summed = CompressedSum(comp_state, n_workers, group,
                                           shards)
                summed.add(i, tree_unflatten(params, acc))
                continue
            if total is None:
                # The sums ride in the last buffer's tail: one all-reduce of
                # these buffers is the master combine (of the leaves whose
                # totals are not reduce-scattered).
                whole = [k for k, c in enumerate(axis.cut) if c is None]
                bufs, views = flat_buckets(
                    [tuple(plist[k].shape) for k in whole], torch.float32,
                    device, tail=2)
                total = [None if c is None else torch.zeros(
                    p.shape, dtype=torch.float32, device=device)
                    for p, c in zip(plist, axis.cut)]
                for k, v in zip(whole, views):
                    total[k] = v
            for t, a in zip(total, acc):
                t += a.to(torch.float32)
        del acc, work, plist
        if compress_grads:
            bufs = [sums]
        else:
            bufs[-1][-2:] = sums
            sums = bufs[-1][-2:]
        if group is not None:
            _all_reduce(bufs, group, stats)
        if compress_grads:
            grads, comp_state = summed.result()
            total = tree_leaves(grads)
            stats["collectives"] += summed.collectives
            stats["bytes"] += summed.wire_bytes
            del summed  # its wire buffers
        for k, c in enumerate(axis.cut):
            if c is not None:  # one leaf at a time: its whole total goes
                total[k] = (own_slice(total[k], axis.dp, c) if compress_grads
                            else reduce_scatter_dim(total[k], axis.dp, c))
        nll, ntok = sums.clone().unbind()  # no view keeps the buffers alive
        denom = torch.clamp(ntok, min=1.0)
        for t in total:
            t /= denom
        new_params, new_opt, om = adamw.update(
            tree_unflatten(params, total), opt_state,
            tree_unflatten(params, axis.slices(tree_leaves(params))), lr,
            sharded=sharded, shards=shards, data_sliced=axis.sliced(),
            data=axis.dp)
        new_params = tree_unflatten(params,
                                    axis.rejoin(tree_leaves(new_params)))
        metrics = {"loss": nll / denom, "n_tokens": ntok, **om}
        return new_params, new_opt, comp_state, metrics

    step.stats = stats
    return step


def make_fsdp_train_step(bundle, n_micro: int, donate: bool = False):
    """The reference's GSPMD train step on the bundle's device: fp32 gradient
    accumulation over ``n_micro`` microbatches with per-sample USEC
    inclusion weights.

    step(params, opt_state, batch, weights, lr)
      batch:   schema dict, leading dim = global batch B
      weights: (B,) float — USEC inclusion weight per sample
    returns (new_params, new_opt_state, metrics). Each microbatch's loss and
    metrics are scaled by the mean of its weights (samples are tile-aligned,
    so the weights are 0/1 blocks).

    Over the group of the bundle's data shards (``bundle.data``: the fsdp
    rules' layout), every rank passes the same batch and weights and runs its rows of each
    microbatch: rows ``i·mb + d·mb/D`` onward of microbatch ``i`` on data
    index ``d``, as the reference's batch sharding cuts its leading dim
    (mb a multiple of D). The parameters rest cut over (data, model) and
    the moments by ZeRO-1 (:func:`repro_torch.models.parallel.data_dims`
    with ``moments``; ``shard_params(..., moments=True)`` cuts them); the
    layers gather their leaves as they run, so each micro-step's gradient
    of a cut leaf reaches this rank's total reduce-scattered. The whole
    leaves' totals and the NLL and token sums meet in one all-reduce, the
    whole leaves whose moments are cut are reduce-scattered, and AdamW
    updates the slices. ``step.stats`` counts the step's own data-group
    collectives (the layers' are in ``bundle.data.stats``).

    ``donate``: the step may write the new parameters and moments into the
    ones it is given (the reference's ``donate_argnums=(0, 1)``), so a step
    holds one copy of the optimizer state, not two.

    The bundle's config carries the sequence-parallel residual stream
    (``act_shard_axis``); its ``loss_fn`` cuts and gathers the residual
    over the bundle's model group, and the step needs nothing for it (the
    usec step neither).
    """
    cfg, device, loss_fn = bundle.cfg, bundle.device, bundle.loss_fn
    data = bundle.data
    group = None if data is None else data.group
    rank, world = (0, 1) if data is None else (data.rank, data.size)
    n_model = 1 if bundle.shards is None else bundle.shards.size
    sharded = (None if bundle.shards is None
               else sharded_leaves(cfg, bundle.shards))
    stats = {"collectives": 0, "bytes": 0}
    dp = None
    if data is not None:
        dp = DataShards(group, world, rank)
        dp.stats = stats
    axis = _DataAxis(dp, data_dims(cfg, world, n_model),
                     data_dims(cfg, world, n_model, moments=True))

    def weighted_loss(params, batch, scale):
        nll, metrics = loss_fn(params, batch)
        return nll * scale, {k: v * scale for k, v in metrics.items()}

    def step(params, opt_state, batch, weights, lr):
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        weights = torch.as_tensor(weights, device=device).to(torch.float32)
        mb = weights.shape[0] // n_micro
        if mb % world:
            raise ValueError(f"a microbatch of {mb} rows does not split over "
                             f"{world} data ranks")
        rows = mb // world
        plist = tree_leaves(params)
        total = [torch.zeros(p.shape, dtype=torch.float32, device=device)
                 for p in plist]
        nll = torch.zeros((), dtype=torch.float32, device=device)
        ntok = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(n_micro):
            part = slice(i * mb + rank * rows, i * mb + (rank + 1) * rows)
            scale = torch.mean(weights[i * mb:(i + 1) * mb])
            loss_i, metrics, grads = value_and_grad(
                lambda p, b: weighted_loss(p, b, scale), params,
                {k: v[part] for k, v in batch.items()})
            for t, g in zip(total, grads):
                t += g.to(torch.float32)
            del grads
            nll, ntok = nll + loss_i, ntok + metrics["n_tokens"]
        if world > 1:
            # The leaves whole over data hold this rank's rows' gradients.
            whole = [k for k, (r, c) in enumerate(zip(axis.rest, axis.cut))
                     if r is None and c is None]
            bufs, views = flat_buckets([tuple(plist[k].shape) for k in whole],
                                       torch.float32, device, tail=2)
            for k, v in zip(whole, views):
                total[k] = v.copy_(total[k])
            bufs[-1][-2] = nll
            bufs[-1][-1] = ntok
            _all_reduce(bufs, group, stats)
            nll, ntok = bufs[-1][-2:].clone().unbind()
            for k, (r, c) in enumerate(zip(axis.rest, axis.cut)):
                if r is None and c is not None:
                    total[k] = reduce_scatter_dim(total[k], axis.dp, c)
        denom = torch.clamp(ntok, min=1.0)
        for t in total:
            t /= denom
        new_params, new_opt, om = adamw.update(
            tree_unflatten(params, total), opt_state,
            tree_unflatten(params, axis.slices(plist)), lr, sharded=sharded,
            shards=bundle.shards, data_sliced=axis.sliced(), data=axis.dp,
            inplace=donate)
        new_params = tree_unflatten(params,
                                    axis.rejoin(tree_leaves(new_params)))
        return new_params, new_opt, {"loss": nll / denom, "n_tokens": ntok,
                                     **om}

    step.stats = stats
    return step
