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
    parameters, identically on every rank of a data group, so each slice
    stays replicated over its data group; the gradient norm spans the
    model group.

fsdp mode (:func:`make_fsdp_train_step`)
    the reference's GSPMD step on one device: fp32 gradient accumulation
    over global microbatches, USEC ownership entering as per-sample weights.

The reference's ZeRO-1 ``reduced_grad_shardings`` and its ``worker_axes``
(pure-DP meshes) are not ported (ROADMAP.md item 13c-ii); ``grad_shardings``
is what the model shards do.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import workers_of
from repro_torch.models.layers import dtype_of
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


def make_usec_train_step(bundle, t_stage: int, b_max: int,
                         compress_grads: bool = False, group=None,
                         static_trips: Optional[int] = None):
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
    (their slices). Every rank returns the same metrics, and the ranks of a
    data group the same parameters.

    ``static_trips``: run exactly that many micro-steps per worker, ignoring
    ``n_mb`` (the reference's cost-analysis variant; padded entries carry
    weight 0).

    ``step.stats`` counts the collectives the master combine issued and
    the bytes they reduced, over all calls (the model group's are in
    ``bundle.shards.stats``).
    """
    cfg, device = bundle.cfg, bundle.device
    shards = bundle.shards
    sharded = None
    if shards is not None:
        from repro_torch.models.parallel import sharded_leaves

        sharded = sharded_leaves(cfg, shards)
    acc_dtype = dtype_of(getattr(cfg, "grad_accum_dtype", "float32"))
    loss_fn = bundle.loss_fn
    rank, world = 0, 1
    if group is not None:
        import torch.distributed as dist

        rank, world = dist.get_rank(group), dist.get_world_size(group)
    if static_trips is not None and not 0 <= static_trips <= b_max:
        raise ValueError(f"static_trips {static_trips} outside [0, {b_max}]")
    stats = {"collectives": 0, "bytes": 0}

    def all_reduce(bufs):
        import torch.distributed as dist

        for buf in bufs:
            dist.all_reduce(buf, group=group)
        stats["collectives"] += len(bufs)
        stats["bytes"] += sum(b.numel() * b.element_size() for b in bufs)

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
        plist = tree_leaves(params)
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
                loss_j, metrics, grads = value_and_grad(loss_fn, params, batch)
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
                # these buffers is the master combine.
                bufs, total = flat_buckets([tuple(p.shape) for p in plist],
                                           torch.float32, device, tail=2)
            for t, a in zip(total, acc):
                t += a.to(torch.float32)
        del acc
        if compress_grads:
            bufs = [sums]
        else:
            bufs[-1][-2:] = sums
            sums = bufs[-1][-2:]
        if group is not None:
            all_reduce(bufs)
        if compress_grads:
            grads, comp_state = summed.result()
            total = tree_leaves(grads)
            stats["collectives"] += summed.collectives
            stats["bytes"] += summed.wire_bytes
            del summed  # its wire buffers
        nll, ntok = sums.clone().unbind()  # no view keeps the buffers alive
        denom = torch.clamp(ntok, min=1.0)
        for t in total:
            t /= denom
        new_params, new_opt, om = adamw.update(
            tree_unflatten(params, total), opt_state, params, lr,
            sharded=sharded, shards=shards)
        metrics = {"loss": nll / denom, "n_tokens": ntok, **om}
        return new_params, new_opt, comp_state, metrics

    step.stats = stats
    return step


def make_fsdp_train_step(bundle, n_micro: int):
    """The reference's GSPMD train step on the bundle's device: fp32 gradient
    accumulation over ``n_micro`` microbatches with per-sample USEC
    inclusion weights.

    step(params, opt_state, batch, weights, lr)
      batch:   schema dict, leading dim = global batch B
      weights: (B,) float — USEC inclusion weight per sample
    returns (new_params, new_opt_state, metrics). Each microbatch's loss and
    metrics are scaled by the mean of its weights (samples are tile-aligned,
    so the weights are 0/1 blocks).
    """
    device, loss_fn = bundle.device, bundle.loss_fn

    def weighted_loss(params, batch, w):
        nll, metrics = loss_fn(params, batch)
        scale = torch.mean(w)
        return nll * scale, {k: v * scale for k, v in metrics.items()}

    def step(params, opt_state, batch, weights, lr):
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        weights = torch.as_tensor(weights, device=device).to(torch.float32)
        mb = weights.shape[0] // n_micro
        total = [torch.zeros(p.shape, dtype=torch.float32, device=device)
                 for p in tree_leaves(params)]
        nll = torch.zeros((), dtype=torch.float32, device=device)
        ntok = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(n_micro):
            part = slice(i * mb, (i + 1) * mb)
            loss_i, metrics, grads = value_and_grad(
                lambda p, b: weighted_loss(p, b, weights[part]), params,
                {k: v[part] for k, v in batch.items()})
            for t, g in zip(total, grads):
                t += g.to(torch.float32)
            nll, ntok = nll + loss_i, ntok + metrics["n_tokens"]
        denom = torch.clamp(ntok, min=1.0)
        for t in total:
            t /= denom
        new_params, new_opt, om = adamw.update(
            tree_unflatten(params, total), opt_state, params, lr)
        return new_params, new_opt, {"loss": nll / denom, "n_tokens": ntok,
                                     **om}

    return step
