#!/usr/bin/env python3
"""Training across ranks on the cards this machine has, without the rest
of the smoke run.

Run from the repository root on a CUDA machine:

    python3 train_dist_probe.py              # train_path, train_dist, (a)-(c)
    python3 train_dist_probe.py --tp-only    # only the model-shard runs
    python3 train_dist_probe.py --fsdp-only  # only the data-cut runs (d)-(g)
    python3 train_dist_probe.py --serve-only # only serving over shards (s1)-(s2)
    ... --runs-log PATH                      # also append each run's record
    ... --only NAME[,NAME...]                # --fsdp-only: just these cells

It builds the kernels, takes ``chip_smoke.py``'s ``train_path`` (3 steps of
internvl2-2b at full width and depth on one card through
``repro_torch.launch.train``) and then its ``train_dist``: with four or
more cards, 4 NCCL ranks of the same trainer at full depth under ``python
-m torch.distributed.run``, each step's loss and gradient norm held to
``train_path``'s; with fewer, 4 gloo ranks sharing one card at
``chip_smoke.DIST_DEPTH`` layers.

With four or more cards it then runs the trainer over model shards
(``--model-shards``, NCCL, one card a rank), each held to the same cell's
run on one card within ``chip_smoke``'s TP_* tolerances:
  (a) glm4-9b at full width and 4 layers, 4 workers, D = 1 x M = 4, 3
      steps, against the one-card run of the same cell (2.06 B parameters
      fit one card);
  (b) glm4-9b at full width and depth (40 layers), the same flags: step
      times, each rank's peak, the bytes its model group moves a step;
      step 0's loss against a forward-only pass of step 0's micro-steps on
      one card (the 18.8 GB of bf16 weights fit; the training state does
      not);
  (c) recurrentgemma-2b at full width and depth, 4 workers, D = 2 x M = 2,
      2 steps: the fp32 sum against the one-card run, and the compressed
      sum (its one-card run at full depth holds 2 x 4 B of error feedback
      a parameter a worker more than a card has, so it is held at 3
      layers, one (rglru, rglru, lattn) block, against the one-card run
      there; at full depth its losses must be finite).
The one-card runs go first, each on a card of its own, at once. Each cell
is the trainer's own entry point: this script calls ``main`` of
``repro_torch.launch.train`` with the config's depth cut where a cell says
so (``python3 train_dist_probe.py trainer DEPTH MODE -- ARGS`` under
``torch.distributed.run``; MODE ``forward`` swaps the step for its loss
alone).

With ``--fsdp-only`` and four cards it runs the cells with parameters and
optimizer state cut over the data axis, on a D = 2 x M = 2 mesh:
  (d) qwen1.5-110b at full width through the sharded fsdp step
      (``make_fsdp_train_step`` over the bundle's data shards; FSDP_ROWS
      rows in FSDP_MICRO microbatches a step): at 1 layer and HELD_SEQ
      positions a row held to the same step on one card (step 0's loss
      and norm, and the parameters and first moments after it by
      ``pair_held``, with each off leaf and the MoE routing reported); at
      8 layers and 8192 positions 3 steps, step 0's loss held to a
      forward-only pass on one card;
  (e) llama4-scout-17b-a16e the same way at 1 layer (held to one card) and
      4 layers (3 steps, finite losses);
  and both 1-layer pairs again at the configs' reduced width in fp32,
      held at WITNESS_TOL;
  (f) ZeRO-1 on the usec step (``reduced_grad_shardings``), recurrentgemma-
      2b at full width and depth, cell (c), fp32 and compressed, held to
      the same ranks without ZeRO-1 (losses, norms, parameters, scales and
      each worker's error feedback bitwise);
  (g) the trainer's fsdp placement: qwen1.5-110b at 2 layers through
      ``repro_torch.launch.train`` at 2 x 2, held to 1 x 4.
These cells run as ``python3 train_dist_probe.py fsdp ARCH DEPTH STEPS
MODE SEQ`` and ``... zero1 ARCH DEPTH`` under ``torch.distributed.run`` (one
rank: the one-card baseline); ``--reduced --device cpu`` after them runs
one on gloo ranks on the host at the config's reduced width. Each sharded
fsdp cell is also dry-run on the host while the cards work
(``repro_torch.launch.dryrun.trace_fsdp`` on a fake 2 x 2 group): every
rank's step peak within DRYRUN_PEAK_TOL of the prediction and its data-
and model-group bytes a step equal to it.

With ``--serve-only`` and four cards it serves over model shards (D 1 x M
4, NCCL), the weights and caches cut by the reference's rules:
  (s1) SERVE_PAIRS: qwen1.5-110b at full width, 2 layers fp32 and 4 layers
       bf16; llama4-scout at 1 layer fp32 and 2 layers bf16; each an
       8192-token prompt and chip_smoke.SERVE_STEPS decode steps, first on
       one card (the four at once, one card each), then over four cards
       teacher-forced with the one-card run's greedy tokens, held by
       chip_smoke's serve_tp rules (logits within SERVE_LOGIT_TOL of the
       step's largest, greedy equal where one card's top-2 margin exceeds
       twice that, layer 0's K/V cut within two bf16 ulps, one flash
       launch per attention layer on the local heads) and, for scout, at
       most SERVE_ROUTES_CHANGED of the prefill's routed choices changed;
  (s2) qwen1.5-110b (80 layers) and llama4-scout (48 layers) at full width
       and depth through ``repro_torch.launch.serve.main`` (``python3
       train_dist_probe.py server -- ARGS`` under torch.distributed.run):
       an 8192-token prompt and SERVE_GEN greedy tokens, every rank the
       same tokens, one flash launch per attention layer on the local
       heads, every rank's prefill and decode peaks and its init's setup
       peak within SERVE_PEAK_TOL of ``launch.dryrun``'s trace of the same
       cell (world 4, traced on the host while the cards work), and its
       model group's bytes in the prefill and a decode step equal to it.
Then the flash kernel at the two local-head shapes, beside SDPA and its
bound. The cells run as ``python3 train_dist_probe.py serve NAME ARCH
DEPTH DTYPE [TEACHER]``.

One JSON line per phase (and, with four cards, per run, also appended to
the ``--runs-log`` file when one is named), the card's name and power
limit first; exits non-zero if a check fails.
"""

import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CELL = ["--workers", "4", "--seq-len", "8192", "--tiles-per-worker", "1",
        "--tile-samples", "1", "--replication", "2",
        "--straggler-tolerance", "1", "--drop-stragglers", "1",
        "--log-every", "1"]
GLM = ["--arch", "glm4-9b"] + CELL
RG = ["--arch", "recurrentgemma-2b"] + CELL
# (name, ranks, depth (0: the config's), mode, trainer arguments, hold:
# the one-card run's name, or None)
ONE_CARD = [
    ("glm4_9b_4_layers_one_card", 1, 4, "train", GLM + ["--steps", "3"]),
    ("glm4_9b_forward_one_card", 1, 0, "forward", GLM + ["--steps", "1"]),
    ("recurrentgemma_2b_one_card", 1, 0, "train", RG + ["--steps", "2"]),
    ("recurrentgemma_2b_3_layers_compressed_one_card", 1, 3, "train",
     RG + ["--steps", "2", "--compress-grads"]),
]
SHARDED = [
    ("glm4_9b_4_layers_m4", 4, 4, "train",
     GLM + ["--steps", "3", "--model-shards", "4"],
     "glm4_9b_4_layers_one_card"),
    ("glm4_9b_m4", 4, 0, "train", GLM + ["--steps", "3", "--model-shards", "4"],
     "glm4_9b_forward_one_card"),
    ("recurrentgemma_2b_2x2", 4, 0, "train",
     RG + ["--steps", "2", "--model-shards", "2"],
     "recurrentgemma_2b_one_card"),
    ("recurrentgemma_2b_2x2_compressed", 4, 0, "train",
     RG + ["--steps", "2", "--model-shards", "2", "--compress-grads"], None),
    ("recurrentgemma_2b_3_layers_2x2_compressed", 4, 3, "train",
     RG + ["--steps", "2", "--model-shards", "2", "--compress-grads"],
     "recurrentgemma_2b_3_layers_compressed_one_card"),
]
QWEN, SCOUT = "qwen1.5-110b", "llama4-scout-17b-a16e"
# The fsdp cells: (name, ranks, arch, depth, steps, mode, positions a row,
# reduced: the config's reduced width in fp32, hold: the one-card run's
# name, or None). One card holds neither 1-layer model's training state
# (qwen1.5-110b 3.85 B, llama4-scout 4.27 B parameters: 16 B a parameter
# with the step's gradients) beside the activations of two 8192-position
# rows, so the held pairs run at HELD_SEQ positions a row. The reduced
# pairs are the same steps in fp32 on the cards, held at WITNESS_TOL.
HELD_SEQ, SEQ, REDUCED_SEQ = 2048, 8192, 64
# The one-card runs go to cards in this order, one each, the fifth beside
# the first: the full-width runs first, the reduced ones (a few MB) last.
FSDP_ONE_CARD = [
    ("qwen_1_layer_one_card", 1, QWEN, 1, 2, "train", HELD_SEQ, False),
    ("scout_1_layer_one_card", 1, SCOUT, 1, 2, "train", HELD_SEQ, False),
    ("qwen_8_layers_forward_one_card", 1, QWEN, 8, 1, "forward", SEQ,
     False),
    ("qwen_reduced_one_card", 1, QWEN, 1, 2, "train", REDUCED_SEQ, True),
    ("scout_reduced_one_card", 1, SCOUT, 1, 2, "train", REDUCED_SEQ, True),
]
FSDP_SHARDED = [
    ("qwen_1_layer_2x2", 4, QWEN, 1, 2, "train", HELD_SEQ, False,
     "qwen_1_layer_one_card"),
    ("scout_1_layer_2x2", 4, SCOUT, 1, 2, "train", HELD_SEQ, False,
     "scout_1_layer_one_card"),
    ("qwen_reduced_2x2", 4, QWEN, 1, 2, "train", REDUCED_SEQ, True,
     "qwen_reduced_one_card"),
    ("scout_reduced_2x2", 4, SCOUT, 1, 2, "train", REDUCED_SEQ, True,
     "scout_reduced_one_card"),
    ("qwen_8_layers_2x2", 4, QWEN, 8, 3, "train", SEQ, False,
     "qwen_8_layers_forward_one_card"),
    ("scout_4_layers_2x2", 4, SCOUT, 4, 3, "train", SEQ, False, None),
]
# A held pair's parameters and first moments after step 0. fp32: an
# element is live where the one-card run's |m| is at least LIVE_FLOOR (the
# CPU tests' floor), and the loss, norm, live parameters and live moments
# are held at WITNESS_TOL (the MoE router's moment, a sum of nearly
# cancelling terms, at ROUTER_TOL, as on the CPU). bf16: each leaf's live
# set comes from its own measured layout noise, sigma = the rms over the
# leaf of m_2x2 - m_1card: live where |m_1card| >= LIVE_SIGMAS x sigma; at
# most 1 % of a leaf's live elements more than two bf16 ulps of its top;
# every leaf whose sigma is below COVERAGE[0] of its largest |m| keeps at
# least COVERAGE[1] of its elements live. An MoE pair changes at most
# ROUTES_CHANGED of step 0's routed choices.
LIVE_FLOOR, LIVE_SIGMAS, COVERAGE = 1e-7, 4.0, (1e-2, 0.5)
WITNESS_TOL, ROUTER_TOL, ROUTES_CHANGED = 1e-5, 1e-4, 1e-2
# (f): recurrentgemma-2b at full depth over 4 workers (J = 2, S = 1),
# worker ZERO1_DROPS[s] dropped at step s.
ZERO1_DROPS = (1, 2)
# (g): the trainer at 2 layers, 2 steps.
QWEN_TRAIN = ["--arch", QWEN] + CELL + ["--steps", "2"]
# --serve-only: the served pairs (s1), (name, arch, depth, dtype), each run
# on one card (first, one card each) and over D 1 x M 4 (then, one after
# another): an 8192-token prompt and chip_smoke.SERVE_STEPS decode steps,
# the sharded run teacher-forced with the one-card run's greedy tokens.
SERVE_PAIRS = [
    ("qwen_2_layers_fp32", QWEN, 2, "float32"),
    ("qwen_4_layers_bf16", QWEN, 4, "bfloat16"),
    ("scout_1_layer_fp32", SCOUT, 1, "float32"),
    ("scout_2_layers_bf16", SCOUT, 2, "bfloat16"),
]
SERVE_MODEL_SHARDS = 4
# (s2): each arch at full width and depth through launch.serve.main under
# torch.distributed.run, --gen-len SERVE_GEN (32 greedy tokens: the
# prefill's pick and 31 decode steps, in a cache of 8224 slots, cut on
# slots over 4).
SERVE_GEN = 32
SERVE_ROUTES_CHANGED = 0.01
SERVE_PEAK_TOL = 0.05
# Each one-card run and each sharded run must end within this.
RUN_TIMEOUT_S = 900


def trainer(argv) -> None:
    """``main`` of the trainer with ``argv`` = DEPTH MODE -- ARGS."""
    import dataclasses

    from repro_torch import configs

    depth, mode, args = int(argv[0]), argv[1], argv[3:]
    real = configs.get_config
    if depth:
        configs.get_config = lambda name: dataclasses.replace(
            real(name), n_layers=depth)
    if mode == "forward":
        from repro_torch.optim import adamw
        from repro_torch.runtime import trainstep

        adamw.init = lambda params: {}
        trainstep.make_usec_train_step = forward_step
    from repro_torch.launch.train import main

    main(args)


def forward_step(bundle, t_stage, b_max, compress_grads=False, group=None,
                 static_trips=None):
    """A usec step of one process that only reports its loss: every
    worker's included micro-steps forward, no gradient, the parameters
    unchanged."""
    import numpy as np

    def step(params, opt, comp, staged, mb_slot, mb_inc, n_mb, lr):
        nll = ntok = torch.zeros((), dtype=torch.float32, device=bundle.device)
        n_mb = np.asarray(n_mb).reshape(-1)
        with torch.no_grad():
            for i in range(len(n_mb)):
                for j in range(int(n_mb[i])):
                    batch = {k: torch.as_tensor(v[i, int(mb_slot[i, j])],
                                                device=bundle.device)
                             for k, v in staged.items()}
                    loss, m = bundle.loss_fn(params, batch)
                    w = float(mb_inc[i, j])
                    nll, ntok = nll + w * loss, ntok + w * m["n_tokens"]
        return params, opt, comp, {"loss": nll / torch.clamp(ntok, min=1.0),
                                   "n_tokens": ntok,
                                   "grad_norm": torch.zeros(())}

    step.stats = {"collectives": 0, "bytes": 0}
    return step


def start(name, ranks, depth, mode, args, cards):
    """The trainer cell ``args`` at ``depth`` under torch.distributed.run."""
    return launch(name, ranks, ["trainer", str(depth), mode, "--"] + args,
                  cards)


def launch(name, ranks, argv, cards):
    """``ranks`` processes of this script with ``argv`` under
    torch.distributed.run on ``cards``: (name, start time, the process)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True",
               CUDA_VISIBLE_DEVICES=",".join(map(str, cards)))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(ranks), os.path.abspath(__file__)] + argv
    return name, time.perf_counter(), subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=ROOT)


def _cell_setup(argv, n_workers, n_model):
    """(cfg, device, mesh groups, report helper) of an fsdp or zero1 cell:
    the config at ``argv``'s arch and depth (``--reduced`` for its reduced
    width), the process group joined (NCCL on the card, gloo with
    ``--device cpu``), and on more than one rank a ``(D, n_model)`` mesh:
    its ModelShards (None when n_model is 1) and DataShards."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import (
        coordinates,
        data_group,
        make_worker_mesh,
        model_group,
    )
    from repro_torch.launch.train import join_process_group
    from repro_torch.models.parallel import DataShards, ModelShards

    arch, depth = argv[0], int(argv[1])
    cfg = get_config(arch)
    if "--reduced" in argv:
        cfg = dataclasses.replace(cfg.reduced(), param_dtype="float32")
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    _, device = join_process_group("cpu" if "--device" in argv else None)
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.zeros(1, device=device)
    shards = data = group = None
    rank, world = 0, 1
    if dist.is_initialized() and dist.get_world_size() > 1:
        rank, world = dist.get_rank(), dist.get_world_size()
        mesh = make_worker_mesh(n_workers, n_model, device_type=device.type)
        d, m = coordinates(mesh)
        group = data_group(mesh)
        if n_model > 1:
            shards = ModelShards(model_group(mesh), n_model, m)
        data = DataShards(group, world // n_model, d)
    return cfg, device, shards, data, group, rank, world


def _peak(device):
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)


def _reports(report, rank, world):
    """Every rank's report printed by rank 0 as the trainer prints them."""
    import torch.distributed as dist

    reports = [report]
    if world > 1:
        reports = [None] * world
        dist.all_gather_object(reports, report)
    if rank == 0:
        for r, rep in enumerate(reports):
            print(f"rank {r} of {world}: {json.dumps(rep)}", flush=True)


def fsdp_cell(argv) -> None:
    """``fsdp ARCH DEPTH STEPS MODE SEQ [OUT]``: the sharded fsdp step at
    2 x 2 (one rank: one process), FSDP_ROWS rows of SEQ positions in
    FSDP_MICRO microbatches with chip_smoke's FSDP_WEIGHTS, the step
    donating its state; MODE ``forward``: the weighted loss of step 0's
    batch alone (no optimizer state). With OUT, the parameters and first
    moments after step 0 are gathered whole onto the host and saved there
    (:func:`save_state`). Each step's peak (``step_peaks``: the card's
    ``max_memory_allocated`` from the step's start, its state included)
    is reported beside the run's."""
    import chip_smoke as cs
    from repro_torch.configs.shapes import demo_batch
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models import attention, build_model, moe
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.runtime.trainstep import make_fsdp_train_step

    steps, mode, seq = int(argv[2]), argv[3], int(argv[4])
    out_path = argv[5] if len(argv) > 5 and not argv[5].startswith("--") \
        else None
    cfg, device, shards, data, group, rank, world = _cell_setup(argv, 2, 2)
    bundle = build_model(cfg, device=device, shards=shards, data=data)
    params = bundle.init(torch.Generator(device=device).manual_seed(0))
    opt = {"m": {}, "v": {}}
    if mode == "train":
        opt = cs._zero1_moments(cfg, device, 1 if data is None else data.size,
                                0 if data is None else data.rank, shards)
    batch = demo_batch(cfg, "train", cs.FSDP_ROWS, seq)
    weights = np.asarray(cs.FSDP_WEIGHTS, np.float32)
    shapes, flash = set(), attention._flash
    out = {"losses": [], "grad_norms": [], "step_s": []}

    def spy(q, k, v, causal, window):
        shapes.add((tuple(q.transpose(1, 2).shape), k.shape[2]))
        return flash(q, k, v, causal, window)

    attention._flash = spy
    # Step 0's MoE routing (each call's experts and kept choices), saved
    # with the state: a held pair compares it.
    routing, route = [], moe.route

    def record(router, xt, cfg):
        r = route(router, xt, cfg)
        if len(out["losses"]) == 0:
            routing.append(torch.stack([r.idx, r.keep.long()]).cpu())
        return r

    moe.route = record
    launches0 = flash_attention_cuda.launches
    if mode == "forward":
        out["losses"].append(forward_loss(bundle, params, batch, weights))
    step = make_fsdp_train_step(bundle, cs.FSDP_MICRO, donate=True)
    run_peak, step_peaks = 0, []
    for i in range(steps if mode == "train" else 0):
        if group is not None:
            torch.distributed.barrier(group)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            run_peak = max(run_peak, _peak(device))
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch, weights, cs.DIST_LR)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            step_peaks.append(_peak(device))
        out["step_s"].append(time.perf_counter() - t0)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        if i == 0 and out_path:
            save_state(out_path, params, opt["m"], cfg, shards, data, rank,
                       routing)
    _reports(dict(
        out, model_index=0 if shards is None else shards.rank,
        data_index=0 if data is None else data.rank,
        micro_steps=cs.FSDP_MICRO * len(out["step_s"]),
        attention_kernel_launches=flash_attention_cuda.launches - launches0,
        flash_shapes=sorted([list(q), hk] for q, hk in shapes),
        max_memory_allocated=(None if device.type != "cuda"
                              else max(run_peak, _peak(device))),
        step_peaks=step_peaks,
        resting_bytes=sum(t.numel() * t.element_size() for t in
                          tree_leaves(params) + tree_leaves([opt["m"],
                                                            opt["v"]])),
        tp_bytes=0 if shards is None else shards.stats["bytes"],
        tp_collectives=0 if shards is None else shards.stats["collectives"],
        data_bytes=(0 if data is None else data.stats["bytes"])
        + step.stats["bytes"],
        reduced_bytes=step.stats["bytes"],
        collectives=step.stats["collectives"]), rank, world)


def save_state(path, params, m, cfg, shards, data, rank, routing) -> None:
    """``{"params", "m", "routing"}``: the parameters and first moments
    gathered whole onto the host (every rank calls this; rank 0 saves them,
    ``torch.save``), the moments in their parameters' dtype, and rank 0's
    MoE routing (a list of (2, T, k) tensors)."""
    from repro_torch.models.parallel import unshard_params
    from repro_torch.models.transformer import tree_leaves, tree_unflatten

    whole = unshard_params(params, cfg, shards, device="cpu", dp=data)
    m = unshard_params(m, cfg, shards, device="cpu", dp=data)
    m = tree_unflatten(m, [t.to(p.dtype) for t, p in zip(
        tree_leaves(m), tree_leaves(whole))])
    if rank == 0:
        torch.save({"params": whole, "m": m, "routing": routing}, path)


def forward_loss(bundle, params, batch, weights) -> float:
    """The fsdp step's loss of ``batch`` without a gradient: each
    microbatch's NLL and token sums scaled by its mean weight."""
    import chip_smoke as cs

    mb = len(weights) // cs.FSDP_MICRO
    nll = ntok = 0.0
    with torch.no_grad():
        for i in range(cs.FSDP_MICRO):
            part = slice(i * mb, (i + 1) * mb)
            loss, m = bundle.loss_fn(params, {
                k: torch.as_tensor(v[part], device=bundle.device)
                for k, v in batch.items()})
            scale = float(np.mean(weights[part]))
            nll += float(loss) * scale
            ntok += float(m["n_tokens"]) * scale
    return nll / max(ntok, 1.0)


def zero1_cell(argv) -> None:
    """``zero1 ARCH DEPTH``: the usec step at 2 x 2 (4 workers, one tile
    each, worker ZERO1_DROPS[s] dropped at step s), fp32 and compressed,
    without and with ZeRO-1: each rank's losses, norms, step times, peaks
    and data-group bytes, and whether ZeRO-1 equals the run without it
    (losses, norms, the parameters and each worker's scales and error
    feedback after every step, by exact digests)."""
    import chip_smoke as cs
    from repro_torch.launch.mesh import workers_of
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.runtime.compression import init_state
    from repro_torch.runtime.trainstep import make_usec_train_step

    cfg, device, shards, data, group, rank, world = _cell_setup(argv, 4, 2)
    depth = cfg.n_layers
    seq = 64 if "--reduced" in argv else cs.TRAIN_SEQ
    bundle, init, t_stage, b_max, args, n_attn = cs._dist_cell(
        device, depth, argv[0], 4, ZERO1_DROPS, shards, cfg=cfg, seq=seq)
    mine = workers_of(data.rank, data.size, 4)
    specs = cs._zero1_specs(cfg, data.size, shards.size)
    report = {"model_index": shards.rank, "data_index": data.rank,
              "workers": list(mine), "attention_layers": n_attn,
              "micro_steps": sum(int(a[3][mine.start:mine.stop].sum())
                                 for a in args), "modes": {}}

    def digest(tree):
        return [cs.tensor_digest(t.float()) for t in tree_leaves(tree)]

    for mode in ("fp32", "compressed"):
        for zero1 in (False, True):
            comp = init_state(init(), len(mine)) if mode == "compressed" \
                else None
            step = make_usec_train_step(
                bundle, t_stage, b_max, compress_grads=comp is not None,
                group=group, reduced_grad_shardings=specs if zero1 else None)
            params = init()
            opt = (cs._zero1_moments(cfg, device, data.size, data.rank,
                                     shards) if zero1 else adamw.init(params))
            if device.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(device)
            run = {"loss": [], "grad_norm": [], "step_s": [], "digests": []}
            for a in args:
                torch.distributed.barrier(group)
                t0 = time.perf_counter()
                params, opt, comp, m = step(params, opt, comp, *a)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                run["step_s"].append(time.perf_counter() - t0)
                run["loss"].append(float(m["loss"]))
                run["grad_norm"].append(float(m["grad_norm"]))
                run["digests"].append(digest(params) + (
                    [] if comp is None else digest(comp)))
            run.update(max_memory_allocated=_peak(device),
                       data_bytes_per_step=step.stats["bytes"] / len(args))
            report["modes"][f"{mode}_{'zero1' if zero1 else 'whole'}"] = run
            del params, opt, comp, step
    report["zero1_bitwise"] = {
        mode: all(report["modes"][f"{mode}_zero1"][k]
                  == report["modes"][f"{mode}_whole"][k]
                  for k in ("loss", "grad_norm", "digests"))
        for mode in ("fp32", "compressed")}
    for run in report["modes"].values():
        run["digests"] = len(run["digests"][0])
    _reports(report, rank, world)


def pair_held(path, one_path, reduced) -> dict:
    """A held pair's state after step 0 (:func:`save_state`: the sharded
    run's at ``path``, the one-card run's at ``one_path``), compared on the
    host by ``chip_smoke.params_held`` with the first moments: fp32
    (``reduced``) every live parameter and moment within WITNESS_TOL; bf16
    the live set from each leaf's layout noise (LIVE_SIGMAS, COVERAGE) and
    at most TP_PARAM_SHARE of its live elements more than two ulps apart
    (the moments are reported, not held); an MoE pair at most
    ROUTES_CHANGED of step 0's routed choices changed. The files are
    removed after. An error is a failed record."""
    import chip_smoke as cs
    from repro_torch.models.transformer import tree_leaves

    try:
        got = torch.load(path, weights_only=True)
        want = torch.load(one_path, weights_only=True)
    except (FileNotFoundError, RuntimeError) as e:
        return {"ok": False, "error": str(e)[-2000:]}
    cpu = torch.device("cpu")
    if reduced:
        floor = LIVE_FLOOR
        out = cs.params_held(
            got["params"], want["params"], 1, cpu, want["m"], got["m"],
            floor, tol=WITNESS_TOL, share_tol=0.0,
            m_tol=lambda key: ROUTER_TOL if "router" in key else WITNESS_TOL)
    else:
        floor = None
        out = cs.params_held(got["params"], want["params"], 1, cpu,
                             want["m"], got["m"], live_sigmas=LIVE_SIGMAS,
                             coverage=COVERAGE)
    for p in (path, one_path):
        os.remove(p)
    pairs = list(zip(got["routing"], want["routing"]))
    changed = sum(int((a != b).any(0).sum()) for a, b in pairs)
    choices = sum(b[0].numel() for _, b in pairs)
    routes_ok = changed <= ROUTES_CHANGED * choices
    return dict(out, ok=bool(out["ok"] and routes_ok), live_floor=floor,
                live_sigmas=None if reduced else LIVE_SIGMAS,
                moe_choices=choices, moe_choices_changed=changed,
                moe_routes_held=routes_ok,
                routing_calls=[len(got["routing"]), len(want["routing"])])


# The dry-run of each sharded fsdp cell (repro_torch.launch.dryrun on a
# fake 2 x 2 group, in this process): every rank's step peak within
# DRYRUN_PEAK_TOL of the predicted peak (for cells whose predicted peak is
# at least DRYRUN_PEAK_FLOOR: below it the card's fixed cuBLAS workspaces,
# which the program's tensors do not include, are a large share), and each
# rank's data-group and model-group bytes a step (the layers' and the
# step's ``stats``: whole tensors) equal to the dry-run's.
DRYRUN_PEAK_TOL, DRYRUN_PEAK_FLOOR = 0.05, 2 ** 30


def fsdp_prediction(arch, depth, seq, reduced) -> dict:
    """The dry-run of ``fsdp ARCH DEPTH ... SEQ`` at 2 x 2 (rank 0, one
    step): its peak, its data- and model-group bytes, the trace's seconds."""
    import dataclasses

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import trace_fsdp
    from repro_torch.launch.mesh import MeshSpec

    cfg = get_config(arch)
    if reduced:
        cfg = dataclasses.replace(cfg.reduced(), param_dtype="float32")
    cfg = dataclasses.replace(cfg, n_layers=depth)
    t0 = time.perf_counter()
    res = trace_fsdp(cfg, MeshSpec((2, 2), ("data", "model")),
                     cs.FSDP_MICRO, cs.FSDP_ROWS, seq, cs.FSDP_WEIGHTS)
    cost, names = res["cost"], res["group_names"]
    return {"peak_bytes": max(cost.peak_bytes, res["argument_bytes"]),
            "argument_bytes": res["argument_bytes"],
            "flops": cost.flops,
            "data_bytes": cost.groups.get(names["data"], {}).get("bytes", 0),
            "model_bytes": cost.groups.get(names["model"], {}).get("bytes",
                                                                   0),
            "trace_s": time.perf_counter() - t0}


def dryrun_held(rec, reports, pred) -> bool:
    """``rec`` gains the dry-run's prediction and how every rank's run
    compares with it; True when the rule above holds."""
    steps = [max(r["step_peaks"]) for r in reports]
    peak = pred["peak_bytes"]
    peak_err = [abs(s - peak) / peak for s in steps]
    data = [r["data_bytes"] / max(len(r["step_s"]), 1) for r in reports]
    model = [r["tp_bytes"] / max(len(r["step_s"]), 1) for r in reports]
    peak_held = peak < DRYRUN_PEAK_FLOOR or max(peak_err) <= DRYRUN_PEAK_TOL
    bytes_held = all(d == pred["data_bytes"] for d in data) and all(
        m == pred["model_bytes"] for m in model)
    rec["dryrun"] = dict(pred, step_peak_per_rank=steps,
                         peak_rel_err=peak_err, peak_held=peak_held,
                         data_bytes_per_rank=data, model_bytes_per_rank=model,
                         bytes_held=bytes_held)
    return peak_held and bytes_held


def finish(run):
    """(the run's record, its rank reports)."""
    name, t0, proc = run
    out, err = proc.communicate(timeout=RUN_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{name} exited {proc.returncode}:\n"
                             f"{out[-2000:]}\n{err[-4000:]}")
    reports = [json.loads(x) for x in re.findall(
        r"^rank \d+ of \d+: (\{.*\})$", out, re.M)]
    head = reports[0]
    rec = {"name": name, "wall_s": wall}
    shapes = re.search(r"^flash_shapes: (.*)$", out, re.M)
    if shapes:
        rec["flash_shapes"] = json.loads(shapes.group(1))
    if "losses" not in head:
        return rec, reports
    steps = max(len(head["step_s"]), 1)
    per_step = {k: [r[k] / steps for r in reports] for k in (
        "tp_bytes", "tp_collectives", "reduced_bytes", "data_bytes")
        if k in head}
    rec.update({"losses": head["losses"], "grad_norms": head["grad_norms"],
                "step_s": head["step_s"],
                "peak_gb_per_rank": [(r["max_memory_allocated"] or 0) / 1e9
                                     for r in reports],
                **{f"{k}_per_step": v for k, v in per_step.items()},
                "flash_launches": [r["attention_kernel_launches"]
                                   for r in reports],
                "micro_steps": [r["micro_steps"] for r in reports],
                "model_index": [r["model_index"] for r in reports]})
    return rec, reports


def phase_train_tp4(smi, runs_log=None) -> bool:
    """The one-card runs at once (one card each), then the sharded runs one
    after another on four cards; each held to its one-card run."""
    import chip_smoke as cs
    from repro_torch.configs import get_config

    t0 = time.perf_counter()

    def keep(rec):
        print(json.dumps(rec), flush=True)
        if runs_log:
            with open(runs_log, "a") as fh:
                fh.write(json.dumps(rec) + "\n")

    runs = [start(*cell, cards=[i]) for i, cell in enumerate(ONE_CARD)]
    one = {}
    for run in runs:
        one[run[0]] = finish(run)[0]
        keep(one[run[0]])
    ok = True
    records = []
    for name, ranks, depth, mode, args, hold in SHARDED:
        rec, reports = finish(start(name, ranks, depth, mode, args,
                                    cards=list(range(4))))
        arch = args[args.index("--arch") + 1]
        cfg = get_config(arch)
        layers = depth or cfg.n_layers
        n_attn = sum(cfg.layer_pattern[i % len(cfg.layer_pattern)]
                     in cs.ATTENTION_KINDS for i in range(layers))
        good = all(math.isfinite(x) for x in rec["losses"]) and all(
            r["attention_kernel_launches"] == 2 * n_attn * r["micro_steps"]
            for r in reports)
        if hold is not None:
            want = one[hold]
            n = min(len(want["losses"]), len(rec["losses"]))
            rec["held_to"] = hold
            rec["loss_rel_err"] = [abs(a - b) / abs(b) for a, b in zip(
                rec["losses"][:n], want["losses"][:n])]
            good &= max(rec["loss_rel_err"]) <= cs.TP_LOSS_TOL
            if mode == "train" and "forward" not in hold:
                rec["grad_norm_rel_err"] = [
                    abs(a - b) / abs(b) for a, b in zip(
                        rec["grad_norms"][:n], want["grad_norms"][:n])]
                good &= max(rec["grad_norm_rel_err"]) <= cs.TP_GNORM_TOL
        rec.update(ok=bool(good), depth=layers, attention_layers=n_attn)
        keep(rec)
        records.append(rec)
        ok &= good
    cs.emit({"phase": "train_tp4", "cards": torch.cuda.device_count(),
             "one_card": one, "sharded": records,
             "tolerances": {"loss": cs.TP_LOSS_TOL,
                            "grad_norm": cs.TP_GNORM_TOL},
             "phase_s": time.perf_counter() - t0, "nvidia_smi": smi})
    return ok


def phase_train_fsdp4(smi, runs_log=None) -> bool:
    """Cells (d)-(g): the one-card runs at once (one card each), then the
    sharded runs one after another on four cards; each held as the module
    docstring says."""
    import dataclasses

    import chip_smoke as cs
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    records, ok = [], True

    def keep(rec):
        print(json.dumps(rec), flush=True)
        if runs_log:
            with open(runs_log, "a") as fh:
                fh.write(json.dumps(rec) + "\n")

    only = (sys.argv[sys.argv.index("--only") + 1].split(",")
            if "--only" in sys.argv else None)
    wanted = (lambda name: True) if only is None else only.__contains__
    saved = os.path.join(ROOT, "build", "fsdp4")
    os.makedirs(saved, exist_ok=True)

    def saved_at(name):
        return os.path.join(saved, f"{name}.pt")

    def fsdp_argv(name, arch, depth, steps, mode, seq, reduced,
                  held=False):
        return ["fsdp", arch, str(depth), str(steps), mode, str(seq)] + (
            [saved_at(name)] if held else []) + (
            ["--reduced"] if reduced else [])

    def ended(run):
        """``finish(run)``, or a failed record and no reports: one cell's
        failure (a card out of memory) does not stop the others."""
        try:
            return finish(run)
        except (AssertionError, subprocess.TimeoutExpired) as e:
            run[2].kill()
            return {"name": run[0], "ok": False, "error": str(e)[-3000:]}, []

    held_pairs = {hold for *_, hold in FSDP_SHARDED if hold}
    # The dry-runs trace on the host while the cards run the cells.
    pool = ThreadPoolExecutor(1)
    predictions = {
        name: pool.submit(fsdp_prediction, arch, depth, seq, reduced)
        for name, _, arch, depth, _, mode, seq, reduced, _ in FSDP_SHARDED
        if wanted(name) and mode == "train"}
    cards = torch.cuda.device_count()
    runs = [launch(name, 1, fsdp_argv(
        name, *cell, held=name in held_pairs and cell[3] == "train"),
        [i % cards])
        for i, (name, _, *cell) in enumerate(
            c for c in FSDP_ONE_CARD if wanted(c[0]))]
    one = {}
    for run in runs:
        one[run[0]] = ended(run)[0]
        keep(one[run[0]])

    def held(rec, want, norms, steps=None, tol=None):
        """Losses (and norms) of the first ``steps`` steps (all by
        default) within the TP_* tolerances (or ``tol``) of ``want``'s."""
        if "losses" not in want:
            return False
        n = min(len(want["losses"]), len(rec["losses"]), steps or 1 << 30)
        rec["loss_rel_err"] = [abs(a - b) / abs(b) for a, b in zip(
            rec["losses"][:n], want["losses"][:n])]
        good = max(rec["loss_rel_err"]) <= (tol or cs.TP_LOSS_TOL)
        if norms:
            rec["grad_norm_rel_err"] = [abs(a - b) / abs(b) for a, b in zip(
                rec["grad_norms"][:n], want["grad_norms"][:n])]
            good &= max(rec["grad_norm_rel_err"]) <= (tol or cs.TP_GNORM_TOL)
        return good

    compares = []
    for (name, ranks, arch, depth, steps, mode, seq, reduced,
         hold) in FSDP_SHARDED:
        if not wanted(name):
            continue
        pred = predictions.get(name)
        try:
            pred = None if pred is None else pred.result()
        except Exception as e:  # noqa: BLE001 - a failed record
            pred = {"error": repr(e)[-2000:]}
        params = hold is not None and mode == "train" and "forward" not in hold
        rec, reports = ended(launch(name, ranks, fsdp_argv(
            name, arch, depth, steps, mode, seq, reduced, held=params),
            list(range(4))))
        if not reports:
            keep(rec)
            records.append(rec)
            ok = False
            continue
        cfg = get_config(arch)
        cfg = dataclasses.replace(cfg.reduced() if reduced else cfg,
                                  n_layers=depth)
        n_attn = cs.attention_layer_count(cfg)
        # The kernel runs above attn_chunk positions (the reduced pairs'
        # attention is the plain one).
        per_micro = 2 * n_attn if seq > cfg.attn_chunk else 0
        good = all(math.isfinite(x) for x in rec["losses"]) and all(
            r["attention_kernel_launches"] == per_micro * r["micro_steps"]
            for r in reports)
        if hold is not None and params:
            # Both runs start from the same weights: step 0's loss and norm
            # are held, and the parameters and first moments after it
            # (pair_held). The later losses are reported, not held: on a
            # batch the 1-layer model nearly memorizes in a step, the next
            # loss magnifies the first update's sign noise (AdamW moves an
            # element by about lr x sign(g), so where g is zero to
            # rounding the two runs may move it 2 lr apart).
            rec["held_to"] = hold
            good &= held(rec, one.get(hold, {}), True, steps=1,
                         tol=WITNESS_TOL if reduced else None)
            # On the host, beside the next cell's run; its record follows.
            compares.append((name, pool.submit(
                pair_held, saved_at(name), saved_at(hold), reduced)))
            if "losses" in one.get(hold, {}):
                rec["later_loss_rel_err"] = [abs(a - b) / abs(b) for a, b in
                                             zip(rec["losses"][1:],
                                                 one[hold]["losses"][1:])]
        elif hold is not None:
            rec["held_to"] = hold
            good &= held(rec, one.get(hold, {}), False)
        if pred is not None:
            if "error" in pred:
                rec["dryrun"] = pred
                good = False
            else:
                good &= dryrun_held(rec, reports, pred)
        rec.update(ok=bool(good), depth=depth, seq=seq,
                   attention_layers=n_attn,
                   flash_shapes=reports[0]["flash_shapes"],
                   resting_gb_per_rank=[r["resting_bytes"] / 1e9
                                        for r in reports])
        keep(rec)
        records.append(rec)
        ok &= good
    for name, done in compares:
        try:
            rec = {"name": f"{name}_params", **done.result()}
        except Exception as e:  # noqa: BLE001 - a failed record
            rec = {"name": f"{name}_params", "ok": False,
                   "error": repr(e)[-2000:]}
        keep(rec)
        records.append(rec)
        ok &= rec["ok"]
    pool.shutdown()
    if wanted("recurrentgemma_2b_2x2_zero1"):
        rec, reports = ended(launch("recurrentgemma_2b_2x2_zero1", 4,
                                    ["zero1", "recurrentgemma-2b", "0"],
                                    list(range(4))))
        rec.update(ok=bool(reports) and all(
            all(r["zero1_bitwise"].values()) for r in reports),
            ranks_detail=reports)
        keep(rec)
        records.append(rec)
        ok &= rec["ok"]
    trained = {}
    for m in (4, 2) if wanted("qwen_2_layers_trainer_2x2") else ():
        name = f"qwen_2_layers_trainer_{4 // m}x{m}"
        rec, reports = ended(start(name, 4, 2, "train",
                                   QWEN_TRAIN + ["--model-shards", str(m)],
                                   list(range(4))))
        rec["resting_gb_per_rank"] = [r["resting_bytes"] / 1e9
                                      for r in reports]
        trained[m] = rec
    if trained:
        rec = trained[2]
        rec["held_to"] = trained[4]["name"]
        rec["ok"] = bool("losses" in rec and held(rec, trained[4], True)
                         and all(math.isfinite(x) for x in rec["losses"]))
        for r in trained.values():
            keep(r)
            records.append(r)
        ok &= rec["ok"]
    cs.emit({"phase": "train_fsdp4", "cards": torch.cuda.device_count(),
             "one_card": one, "sharded": records,
             "tolerances": {"loss": cs.TP_LOSS_TOL,
                            "grad_norm": cs.TP_GNORM_TOL},
             "phase_s": time.perf_counter() - t0, "nvidia_smi": smi})
    return ok


def serve_cell(argv) -> None:
    """``serve NAME ARCH DEPTH DTYPE [TEACHER]``: one served pair's run on
    this world's cards (one rank: one card; more: a D 1 x M mesh), fed the
    run TEACHER's greedy picks when named; each rank saves its run (the
    logits gathered whole) under build/serve4/ and reports."""
    import chip_smoke as cs
    import torch.distributed as dist
    from repro_torch.configs import demo_batch
    from repro_torch.launch.mesh import (
        coordinates,
        make_worker_mesh,
        model_group,
    )
    from repro_torch.launch.train import join_process_group
    from repro_torch.models import build_model
    from repro_torch.models.parallel import ModelShards

    name, arch, depth, dtype = argv[0], argv[1], int(argv[2]), argv[3]
    cfg = cs.serve_cfg(arch, depth, dtype)
    _, device = join_process_group(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.zeros(1, device=device)
    rank, world = dist.get_rank(), dist.get_world_size()
    shards = None
    m = 0
    if world > 1:
        mesh = make_worker_mesh(1, world, device_type="cuda")
        _, m = coordinates(mesh)
        shards = ModelShards(model_group(mesh), world, m)
    bundle = build_model(cfg, device=device, shards=shards)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device=device).manual_seed(
        cs.SERVE_SEED))
    torch.cuda.synchronize(device)
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(device)
    batch = demo_batch(cfg, "prefill", cs.MODEL_BATCH, cs.PROMPT_LEN,
                       seed=cs.SERVE_SEED)
    base = os.path.join(ROOT, "build", "serve4")
    tokens = None
    if len(argv) > 4:
        tokens = torch.load(os.path.join(base, f"{argv[4]}_rank0.pt"))[
            "picks"][:, :cs.SERVE_STEPS]
    torch.cuda.reset_peak_memory_stats(device)
    run = cs.serve_run(bundle, params, batch, cs.SERVE_STEPS, tokens,
                       routes=cfg.is_moe)
    run["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    torch.save(run, os.path.join(base, f"{name}_rank{rank}.pt"))
    _reports({"model_index": m, "init_s": init_s,
              "init_peak_gb": init_peak / 1e9, "peak_gb": run["peak_gb"],
              **{k: run[k] for k in ("prefill_s", "decode_s", "model_bytes",
                                     "flash_launches", "flash_shapes")}},
             rank, world)


def server(argv) -> None:
    """``server -- ARGS``: ``repro_torch.launch.serve.main(ARGS)`` with the
    flash kernel's local-head shapes recorded; rank 0 prints every rank's
    as ``flash_shapes: [...]`` after the serve's report lines."""
    import torch.distributed as dist
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import join_process_group
    from repro_torch.models import attention

    _, device = join_process_group(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.zeros(1, device=device)
    shapes, flash = set(), attention._flash

    def spy(q, k, v, causal, window):
        shapes.add((tuple(q.transpose(1, 2).shape), k.shape[2]))
        return flash(q, k, v, causal, window)

    attention._flash = spy
    serve_main(argv[1:])
    mine = sorted([list(q), hk] for q, hk in shapes)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    if dist.get_rank() == 0:
        print("flash_shapes: " + json.dumps(every), flush=True)


def serve_prediction(arch) -> dict:
    """The dry-run of (s2)'s cell at world 4 (D 1 x M 4, rank 0): the
    prefill's and one decode step's peaks, model-group bytes and setup
    peak."""
    import chip_smoke as cs
    from repro_torch.launch.dryrun import trace_serve
    from repro_torch.launch.mesh import MeshSpec

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    spec = MeshSpec((1, SERVE_MODEL_SHARDS), ("data", "model"))
    out = {}
    t0 = time.perf_counter()
    for kind, seq in (("prefill", cs.PROMPT_LEN),
                      ("decode", cs.PROMPT_LEN + SERVE_GEN)):
        res = trace_serve(cfg, kind, cs.MODEL_BATCH, seq, spec)
        cost, names = res["cost"], res["group_names"]
        out[kind] = {"peak_bytes": max(cost.peak_bytes,
                                       res["argument_bytes"]),
                     "argument_bytes": res["argument_bytes"],
                     "setup_peak_bytes": res["setup_peak_bytes"],
                     "model_bytes": cost.groups.get(names["model"], {}).get(
                         "bytes", 0)}
    out["trace_s"] = time.perf_counter() - t0
    return out


def phase_serve_tp4(smi, runs_log=None) -> bool:
    """(s1) and (s2): the one-card runs of SERVE_PAIRS at once (one card
    each), their sharded runs one after another on four cards, each held
    by chip_smoke's serve_tp rules (and scout's routing); then each arch at
    full depth through launch.serve.main, held to its dry-run; last, the
    flash kernel at the two local-head shapes."""
    import shutil

    import chip_smoke as cs
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    records, ok = [], True
    base = os.path.join(ROOT, "build", "serve4")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)

    def keep(rec):
        print(json.dumps(rec), flush=True)
        if runs_log:
            with open(runs_log, "a") as fh:
                fh.write(json.dumps(rec) + "\n")

    pool = ThreadPoolExecutor(max_workers=1)
    predicted = {a: pool.submit(serve_prediction, a) for a in (QWEN, SCOUT)}
    runs = [launch(name, 1, ["serve", name, arch, str(depth), dtype], [i])
            for i, (name, arch, depth, dtype) in enumerate(SERVE_PAIRS)]
    one = {}
    for run in runs:
        rec, reports = finish(run)
        one[rec["name"]] = reports[0]
        rec.update(reports[0])
        keep(rec)
    for name, arch, depth, dtype in SERVE_PAIRS:
        sharded = f"{name}_m{SERVE_MODEL_SHARDS}"
        rec, reports = finish(launch(
            sharded, SERVE_MODEL_SHARDS,
            ["serve", sharded, arch, str(depth), dtype, name],
            list(range(SERVE_MODEL_SHARDS))))
        cfg = cs.serve_cfg(arch, depth, dtype)
        base_run = torch.load(os.path.join(base, f"{name}_rank0.pt"))
        local = [[[1, cfg.n_heads // SERVE_MODEL_SHARDS, cs.PROMPT_LEN,
                   cfg.head_dim], cfg.n_kv_heads // SERVE_MODEL_SHARDS]]
        held = []
        for r in range(SERVE_MODEL_SHARDS):
            run = torch.load(os.path.join(base, f"{sharded}_rank{r}.pt"))
            h = cs.serve_held(base_run, run, dtype, cs._kv_cut(
                base_run["kv_first"], cfg, reports[r]["model_index"],
                SERVE_MODEL_SHARDS))
            if cfg.is_moe:
                h["routes_changed"] = float(
                    (run["routes"] != base_run["routes"]).float().mean())
                h["ok"] &= h["routes_changed"] <= SERVE_ROUTES_CHANGED
            h["flash_ok"] = (reports[r]["flash_launches"] ==
                             cs.attention_layer_count(cfg)
                             and reports[r]["flash_shapes"] == local)
            h["ok"] &= h["flash_ok"]
            held.append(h)
        rec.update(arch=arch, depth=depth, dtype=dtype, held_to=name,
                   one_card=one[name], ranks=reports, held=held,
                   ok=all(h["ok"] for h in held))
        keep(rec)
        records.append(rec)
        ok &= rec["ok"]
    for arch in (QWEN, SCOUT):
        cfg = get_config(arch)
        name = f"{arch}_full_depth_m{SERVE_MODEL_SHARDS}"
        args = ["server", "--", "--arch", arch, "--model-shards",
                str(SERVE_MODEL_SHARDS), "--batch", str(cs.MODEL_BATCH),
                "--prompt-len", str(cs.PROMPT_LEN), "--gen-len",
                str(SERVE_GEN)]
        rec, reports = finish(launch(name, SERVE_MODEL_SHARDS, args,
                                     list(range(SERVE_MODEL_SHARDS))))
        pred = predicted[arch].result()
        shapes = rec.pop("flash_shapes")
        n_attn = cs.attention_layer_count(cfg)
        local = [[[1, cfg.n_heads // SERVE_MODEL_SHARDS, cs.PROMPT_LEN,
                   cfg.head_dim], cfg.n_kv_heads // SERVE_MODEL_SHARDS]]
        peak_err = {k: [abs(r[f"{k}_peak_bytes"] - pred[k]["peak_bytes"])
                        / pred[k]["peak_bytes"] for r in reports]
                    for k in ("prefill", "decode")}
        init_pred = pred["prefill"]["setup_peak_bytes"]
        init_err = [abs(r["init_peak_gb"] * 1e9 - init_pred) / init_pred
                    for r in reports]
        checks = {
            "same_tokens": all(r["tokens"] == reports[0]["tokens"]
                               for r in reports),
            "flash": all(r["attention_kernel_launches"] == n_attn
                         for r in reports) and all(s == local
                                                   for s in shapes),
            "peaks": max(max(v) for v in peak_err.values())
            <= SERVE_PEAK_TOL,
            "init_peak": max(init_err) <= SERVE_PEAK_TOL,
            "model_bytes": all(
                r["model_bytes"]["prefill"] == pred["prefill"]["model_bytes"]
                and r["model_bytes"]["decode_step"]
                == pred["decode"]["model_bytes"] for r in reports)}
        rec.update(arch=arch, layers=cfg.n_layers, ranks=reports,
                   flash_shapes=shapes, attention_layers=n_attn,
                   prediction=pred, peak_rel_err=peak_err,
                   init_peak_rel_err=init_err, checks=checks,
                   ok=all(checks.values()))
        keep(rec)
        records.append(rec)
        ok &= rec["ok"]
    dev = torch.device("cuda", 0)
    flash = {n: cs.flash_layer(case, dev, 0) for n, case in (
        ("qwen_m4", cs.FLASH_LAYER_QWEN_M4),
        ("scout_m4", cs.FLASH_LAYER_SCOUT_M4))}
    cs.emit({"phase": "serve_tp4", "cards": torch.cuda.device_count(),
             "one_card": one, "runs": records, "flash": flash,
             "tolerances": {"logit": cs.SERVE_LOGIT_TOL,
                            "kv_bf16_ulps": cs.SERVE_KV_ULPS,
                            "routes_changed": SERVE_ROUTES_CHANGED,
                            "peak": SERVE_PEAK_TOL},
             "phase_s": time.perf_counter() - t0, "nvidia_smi": smi})
    return ok


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] in ("trainer", "fsdp", "zero1",
                                             "serve", "server"):
        cell = {"trainer": trainer, "fsdp": fsdp_cell, "zero1": zero1_cell,
                "serve": serve_cell, "server": server}[sys.argv[1]]
        try:
            cell(sys.argv[2:])
        finally:
            if sys.argv[1] != "trainer" and \
                    torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
        return 0
    if not torch.cuda.is_available():
        print("train_dist_probe: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.build_all()
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    log = (sys.argv[sys.argv.index("--runs-log") + 1]
           if "--runs-log" in sys.argv else None)
    four = torch.cuda.device_count() >= 4
    if "--serve-only" in sys.argv:
        if four:
            return 0 if phase_serve_tp4(smi, log) else 1
        cs.phase_serve_tp(dev, smi)
        return 0
    if "--fsdp-only" in sys.argv:
        if four:
            return 0 if phase_train_fsdp4(smi, log) else 1
        cs.phase_train_fsdp(dev, smi)
        return 0
    if "--tp-only" not in sys.argv:
        _, metrics = cs.phase_train_path(
            dev, {"flash_attention": flash_attention_cuda}, smi)
        cs.phase_train_dist(dev, smi, metrics)
    if four:
        if not phase_train_tp4(smi, log):
            return 1
    else:
        cs.phase_train_tp(dev, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
