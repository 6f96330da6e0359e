#!/usr/bin/env python3
"""The control: the plain reference put in the program's place at a lower
precision, judged by the cell's own comparison, which must fail it.

    python3 h100bench/control.py --workload <cell> --seeds 1,2,3 \
        [--precision tf32|bf16] [--jobs N] [--queries N]

For each seed it makes the cell's inputs at the cell's size (X, the jobs'
starting vectors or the served operands), computes what the program would
return with the product in ``--precision`` (the float32 iterate update and
bookkeeping as the program does them), and runs the cell's ``check`` on it.
It prints one JSON line a seed: every compared number, its limit, and
whether the cell would call the run correct. ``--jobs`` / ``--queries``
set how many outputs are judged (a window's worth). Not part of a
benchmark run; PERF.md keeps its readings.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "src"))
sys.path.insert(0, _ROOT)


def powerit_outputs(ctx, n_jobs: int, matmul) -> dict:
    """What a window of ``n_jobs`` jobs would hold, computed with the
    control's product."""
    import numpy as np
    import torch

    from h100bench.harness import data, reference

    cfg, tr = ctx.cell.cfg, ctx.cell.traffic
    dim, steps = int(cfg["matrix_size"]), int(tr["steps_per_job"])
    bits = int(cfg["quantize_bits"])
    first = int(tr["warmup_jobs"])
    x = data.make_matrix(cfg, ctx.seed, ctx.device)
    w0 = torch.as_tensor(data.job_operands(ctx.seed, n_jobs, dim, first).T,
                         device=ctx.device)
    out = reference.power_iteration(x, w0, steps, bits, matmul=matmul)
    del x
    jobs = []
    ys = [y.to(torch.float32).cpu().numpy() for y in out["y"]]
    v = out["eigvec"].cpu().numpy()
    lam = out["eigval"][-1].cpu().numpy()
    res = torch.stack(out["residual"], 1).cpu().numpy()
    for j in range(n_jobs):
        jobs.append({"index": first + j, "ys": [y[:, j] for y in ys],
                     "residuals": list(res[j]), "eigval": float(lam[j]),
                     "eigvec": np.ascontiguousarray(v[:, j])})
    return {"outputs": jobs, "iterations": n_jobs * steps}


def serve_outputs(ctx, n_queries: int, matmul) -> dict:
    import torch

    from h100bench.harness import data
    from h100bench.traffic import open_loop

    cfg, tr = ctx.cell.cfg, ctx.cell.traffic
    pool = open_loop._pool(ctx)
    rate = n_queries / ctx.seconds
    _, which = open_loop.arrivals(ctx.seed, rate, ctx.seconds, len(pool))
    x = data.make_matrix(cfg, ctx.seed, ctx.device)
    ans = matmul(x, torch.as_tensor(pool.T, device=ctx.device)).to(
        torch.float32).cpu().numpy()
    del x
    return {"queries": len(which), "which": which, "pool": pool,
            "answers": [ans[:, k] for k in which]}


def main() -> int:
    import torch

    from h100bench.harness import bench, reference
    from h100bench.harness.main import cache_dirs, judge

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--precision", default="tf32",
                   choices=sorted(reference.CONTROLS))
    p.add_argument("--jobs", type=int, default=200)
    p.add_argument("--queries", type=int, default=1500)
    p.add_argument("--seconds", type=float, default=10.0)
    a = p.parse_args()
    cache_dirs()
    dev = torch.device("cuda", 0)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = bench.cell(a.workload)
    gen = bench.generator(cell.traffic)
    matmul = reference.CONTROLS[a.precision]
    for seed in (int(s) for s in a.seeds.split(",")):
        ctx = bench.Context(cell=cell, seed=seed, seconds=a.seconds,
                            trace=False, device=dev, t_start=T_START)
        t = time.perf_counter()
        if cell.traffic["generator"] == "open_loop":
            rec = serve_outputs(ctx, a.queries, matmul)
        else:
            rec = powerit_outputs(ctx, a.jobs, matmul)
        verdict = gen.check(ctx, rec)
        correct, checks = judge(verdict["checks"], cell.limits)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "precision": a.precision, "correct": correct,
                          "checks": checks, "failed": verdict["failed"],
                          "attempted": verdict["attempted"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
