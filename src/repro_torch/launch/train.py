"""End-to-end elastic trainer, on one process or one process a rank.

Twin of :mod:`repro.launch.train`, with the same flags and loop:

  data pipeline (tile-addressable, placement-staged)
   -> USECScheduler (speeds EWMA, elastic membership, LP + filling)
   -> usec train step (uneven per-worker loops, 1+S redundancy, the sum)
   -> AdamW -> checkpoint every K steps (restartable; the reference's
      on-disk format, so either package resumes the other's)

with per-step preemption/straggler simulation driven by --churn and
--drop-stragglers; the simulated wall time comes from ``simulate_step``.

On one process the N workers run as a loop on one device (``--device``,
CUDA unless named). Under ``python -m torch.distributed.run`` (``WORLD_SIZE``
set) each rank joins one process group (NCCL on ``cuda:LOCAL_RANK``, gloo
with ``--device cpu``). With ``--model-shards M`` the world is a ("data",
"model") mesh of D x M ranks (rank d * M + m): the M ranks of a data index
hold one worker's model between them, cut by the sharding rules
(:mod:`repro_torch.launch.sharding`), and run its micro-steps tensor-
parallel. Each data index runs its contiguous run of the workers
(:func:`repro_torch.launch.mesh.workers_of`); the workers meet at one
all-reduce a step over the data group. Every rank draws the same seeded
scheduler, churn, speed and straggler numbers, and each step all ranks
compare a digest of their plans and raise if they differ. Rank 0 prints
the log and writes the checkpoints (gathered whole over its model group);
a checkpoint resumes at any data x model layout. At the end rank 0 prints
what each rank ran: its workers and model index, micro-steps, attention
kernel launches, step times, the step losses and gradient norms, bytes
all-reduced by the master combine and by the model group, and peak device
memory. In ``dp`` mode (``train_mode``) every leaf is replicated, so model
ranks compute the same step on whole weights, as in the reference; in
``fsdp`` mode the parameters and AdamW moments rest cut over data as well,
by the rules' data-axis entries (the reference's trainer places them by
``param_shardings``), and the usec step gathers them whole once at its
start and reduce-scatters their totals at its end
(:func:`repro_torch.runtime.trainstep.make_usec_train_step`). The report
then also gives each rank's resting bytes (parameters and moments).

Run (on a machine with an NVIDIA GPU; ``--device cpu`` runs the plain
PyTorch versions on the host):
  python -m repro_torch.launch.train --arch internvl2-2b --workers 4 \\
      --replication 2 --straggler-tolerance 1 --drop-stragglers 1 \\
      --tiles-per-worker 1 --tile-samples 1 --seq-len 8192 --steps 3
  python -m repro_torch.launch.train --arch stablelm-1.6b --reduced \\
      --workers 4 --steps 50 --straggler-tolerance 1 --device cpu
  python -m torch.distributed.run --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.train --arch stablelm-1.6b --reduced \\
      --workers 4 --device cpu
  python -m torch.distributed.run --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.train --arch glm4-9b --reduced --workers 2 \\
      --model-shards 2 --device cpu
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import time

import numpy as np


def plan_digest(*arrays) -> int:
    """A 64-bit digest of arrays' dtypes, shapes and bytes."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return int.from_bytes(h.digest()[:8], "little", signed=True)


def check_plans_agree(group, device, step: int, digest: int) -> None:
    """All-gather every rank's plan digest; raise unless they are equal."""
    import torch
    import torch.distributed as dist

    mine = torch.tensor([digest], dtype=torch.int64, device=device)
    got = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    dist.all_gather(got, mine, group=group)
    seen = [int(t) for t in got]
    if len(set(seen)) != 1:
        raise RuntimeError(
            f"step {step}: the ranks' plans differ (digests {seen}); every "
            "rank must draw the same scheduler, churn, speed and straggler "
            "numbers")


def join_process_group(device):
    """(owned, device): under ``torch.distributed.run`` (``WORLD_SIZE`` set
    and no group yet) initialize the default group, NCCL on
    ``cuda:LOCAL_RANK`` or gloo for a CPU ``device``; ``owned`` says this
    call did, so the caller destroys it."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return False, device
    cuda = device is None or torch.device(device).type == "cuda"
    if cuda:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if cuda else "gloo")
    return True, device


def main(argv=None):
    """Train; returns the last step's loss (None when no step ran)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="tiny same-family config")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--model-shards", type=int, default=1)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--tile-samples", type=int, default=2)
    ap.add_argument("--tiles-per-worker", type=int, default=2)
    ap.add_argument("--replication", type=int, default=2)
    ap.add_argument("--straggler-tolerance", type=int, default=0)
    ap.add_argument("--drop-stragglers", type=int, default=0,
                    help="simulate this many dropped workers per step")
    ap.add_argument("--churn", type=float, default=0.0,
                    help="per-step preemption probability per worker")
    ap.add_argument("--speed-sigma", type=float, default=0.3,
                    help="lognormal sigma of simulated worker speeds")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; "
                         "raises without one)")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    if args.model_shards > 1 and not (dist.is_initialized()
                                      or "WORLD_SIZE" in os.environ):
        raise ValueError(
            f"--model-shards {args.model_shards} splits each worker's model "
            "over that many ranks: run under python -m "
            "torch.distributed.run with a world of D x model shards")
    owned, device = join_process_group(args.device)
    try:
        return _train(args, device)
    finally:
        if owned:
            dist.destroy_process_group()


def _train(args, device):
    """The loop of :func:`main` on ``device``, over the default process
    group when there is one."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import MarkovChurnTrace, USECScheduler, cyclic_placement
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch.mesh import (
        coordinates,
        data_group,
        make_worker_mesh,
        model_group,
        workers_of,
    )
    from repro_torch.models import build_model
    from repro_torch.models.parallel import (
        DataShards,
        ModelShards,
        cut_over_data,
    )
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.runtime.compression import init_state as comp_init
    from repro_torch.runtime.executor import block_plan
    from repro_torch.runtime.simulate import (
        SpeedProcess,
        StragglerProcess,
        simulate_step,
    )
    from repro_torch.runtime.trainstep import make_usec_train_step

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = torch.device(device) if device is not None else None

    n, n_model = args.workers, args.model_shards
    group, shards, data, rank, world = None, None, None, 0, 1
    data_index, n_data, model_index = 0, 1, 0
    if dist.is_initialized():
        dev_type = (device.type if device is not None else "cuda")
        mesh = make_worker_mesh(n, n_model, device_type=dev_type)
        group = data_group(mesh)
        rank, world = dist.get_rank(), dist.get_world_size()
        data_index, model_index = coordinates(mesh)
        n_data = world // n_model
        if n_model > 1:
            shards = ModelShards(model_group(mesh), n_model, model_index)
        if cfg.train_mode == "fsdp" and n_data > 1:
            data = DataShards(group, n_data, data_index)
        # NCCL gathers on the card, gloo on the host.
        comm_device = (torch.device("cuda", torch.cuda.current_device())
                       if dist.get_backend() == "nccl"
                       else torch.device("cpu"))
    bundle = build_model(cfg, device=device, shards=shards)
    mine = workers_of(data_index, n_data, n)
    log = print if rank == 0 else (lambda *a, **k: None)
    g_tiles = args.tiles_per_worker * n
    placement = cyclic_placement(n, g_tiles, args.replication)
    pipe = TokenPipeline(cfg, placement, seq_len=args.seq_len,
                         tile_samples=args.tile_samples, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    true_speeds = SpeedProcess(
        base=np.exp(rng.normal(0, args.speed_sigma, n)) + 0.1,
        jitter_sigma=0.05, seed=args.seed,
    )
    sched = USECScheduler(
        placement, rows_per_tile=1,
        initial_speeds=np.ones(n),
        stragglers=args.straggler_tolerance,
        gamma=0.5,
    )
    churn = MarkovChurnTrace(
        n, p_preempt=args.churn, p_arrive=3 * args.churn + 1e-9,
        min_available=max(args.replication, 1 + args.straggler_tolerance),
        seed=args.seed, placement=placement,
        min_holders=1 + args.straggler_tolerance,
    )
    straggle = StragglerProcess(count=args.drop_stragglers, mode="uniform",
                                seed=args.seed)

    params = bundle.init(
        torch.Generator(device=bundle.device).manual_seed(args.seed))
    # Each worker's error feedback spans its model shard, whole over data
    # (the step sums whole gradients).
    comp = comp_init(params, len(mine)) if args.compress_grads else None
    if data is not None:
        params = cut_over_data(params, cfg, n_model, data)
    opt = adamw.init(params)
    t_stage = max(len(z) for z in placement.storage_sets())
    b_max = sched.t_max
    step_fn = make_usec_train_step(bundle, t_stage, b_max,
                                   compress_grads=args.compress_grads,
                                   group=group)

    start = 0
    if args.resume and args.ckpt_dir:
        latest = ckpt.latest_checkpoint(args.ckpt_dir)
        if latest:
            start, params, opt, extra = ckpt.restore_train_state(
                latest, params, opt, cfg, shards, data)
            if "speeds" in extra:
                sched.estimator._s = np.asarray(extra["speeds"])
            log(f"resumed from {latest} at step {start}")

    wall = 0.0
    metrics = None
    step_s, micro_steps, losses, grad_norms = [], 0, [], []
    launches0 = flash_attention_cuda.launches
    for step in range(start, args.steps):
        avail = churn.available
        splan = sched.plan_step(avail)
        speeds_now = true_speeds.sample()
        dropped = straggle.sample(avail, speeds_now)
        timing = simulate_step(splan.plan, speeds_now, dropped=dropped)
        wall += timing.completion_time

        staged = pipe.staged_for_step(step)
        bp = block_plan(splan.plan, staged.slot_of, block_rows=1,
                        stragglers=dropped, b_max=b_max)
        lr = warmup_cosine(step, args.lr, 10, args.steps)
        if group is not None:
            check_plans_agree(None, comm_device, step, plan_digest(
                np.asarray(sorted(avail)), np.asarray(sorted(dropped)),
                staged.slot_of, bp.blk_slot, bp.blk_include, bp.n_blocks,
                np.float64(float(lr))))
        micro_steps += int(bp.n_blocks[mine.start:mine.stop].sum())
        t0 = time.perf_counter()
        params, opt, comp, metrics = step_fn(
            params, opt, comp, staged.arrays, bp.blk_slot, bp.blk_include,
            bp.n_blocks[:, None], lr)
        if bundle.device.type == "cuda":
            torch.cuda.synchronize(bundle.device)
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        grad_norms.append(float(metrics["grad_norm"]))
        # Workers report measured speeds (Algorithm 1 lines 14-15).
        loads = {w: float(splan.plan.loads()[w]) for w in avail}
        durations = {w: float(loads[w] / speeds_now[w]) for w in avail
                     if w not in dropped and loads[w] > 0}
        sched.report(loads, durations)
        churn.step()

        if args.log_every and step % args.log_every == 0:
            log(
                f"step {step:4d} loss={float(metrics['loss']):.4f} "
                f"gnorm={float(metrics['grad_norm']):.3f} "
                f"c*={splan.c_star:.3f} sim_t={timing.completion_time:.3f} "
                f"avail={len(avail)} dropped={list(dropped)}",
                flush=True,
            )
        if ((data_index == 0 or data is not None) and args.ckpt_dir
                and (step + 1) % args.ckpt_every == 0):
            ckpt.save_train_state(
                args.ckpt_dir, step + 1, params, opt, cfg, shards,
                extra={"speeds": sched.estimator.speeds.tolist()},
                write=rank == 0, data=data)
    log(f"done: {args.steps - start} steps, simulated wall time {wall:.2f} "
        f"(speed-aware USEC assignment) on {bundle.device}", flush=True)
    if group is not None:
        tp = shards.stats if shards is not None else {"collectives": 0,
                                                      "bytes": 0}
        report = {
            "workers": list(mine), "model_index": model_index,
            "backend": dist.get_backend(group),
            "device": str(bundle.device), "micro_steps": micro_steps,
            "attention_kernel_launches":
                flash_attention_cuda.launches - launches0,
            "step_s": step_s, "losses": losses, "grad_norms": grad_norms,
            "reduced_bytes": step_fn.stats["bytes"],
            "collectives": step_fn.stats["collectives"],
            "tp_bytes": tp["bytes"], "tp_collectives": tp["collectives"],
            "resting_bytes": sum(
                t.numel() * t.element_size() for t in
                tree_leaves(params) + tree_leaves([opt["m"], opt["v"]])),
            "max_memory_allocated": (
                torch.cuda.max_memory_allocated(bundle.device)
                if bundle.device.type == "cuda" else None)}
        reports = [None] * world
        dist.all_gather_object(reports, report)
        for r, rep in enumerate(reports):
            log(f"rank {r} of {world}: {json.dumps(rep)}", flush=True)
    return float(metrics["loss"]) if metrics is not None else None


if __name__ == "__main__":
    main()
