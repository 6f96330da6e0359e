#!/usr/bin/env python3
"""Training across ranks on the cards this machine has, without the rest
of the smoke run.

Run from the repository root on a CUDA machine:

    python3 train_dist_probe.py            # every phase below
    python3 train_dist_probe.py --tp-only  # only the model-shard runs
    ... --runs-log PATH                    # also append each run's record

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
alone). One JSON line per phase (and, with four cards, per run, also
appended to the ``--runs-log`` file when one is named), the card's name
and power limit first; exits non-zero if a check fails.
"""

import json
import math
import os
import re
import subprocess
import sys
import time

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
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True",
               CUDA_VISIBLE_DEVICES=",".join(map(str, cards)))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(ranks), os.path.abspath(__file__),
           "trainer", str(depth), mode, "--"] + args
    return name, time.perf_counter(), subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=ROOT)


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
    steps = len(head["step_s"])
    return {"name": name, "wall_s": wall, "losses": head["losses"],
            "grad_norms": head["grad_norms"], "step_s": head["step_s"],
            "peak_gb_per_rank": [r["max_memory_allocated"] / 1e9
                                 for r in reports],
            "tp_bytes_per_step": [r["tp_bytes"] / steps for r in reports],
            "tp_collectives_per_step": [r["tp_collectives"] / steps
                                        for r in reports],
            "reduced_bytes_per_step": [r["reduced_bytes"] / steps
                                       for r in reports],
            "flash_launches": [r["attention_kernel_launches"]
                               for r in reports],
            "micro_steps": [r["micro_steps"] for r in reports],
            "model_index": [r["model_index"] for r in reports]}, reports


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


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "trainer":
        trainer(sys.argv[2:])
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
    if "--tp-only" not in sys.argv:
        _, metrics = cs.phase_train_path(
            dev, {"flash_attention": flash_attention_cuda}, smi)
        cs.phase_train_dist(dev, smi, metrics)
    if torch.cuda.device_count() >= 4:
        log = (sys.argv[sys.argv.index("--runs-log") + 1]
               if "--runs-log" in sys.argv else None)
        if not phase_train_tp4(smi, log):
            return 1
    else:
        cs.phase_train_tp(dev, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
