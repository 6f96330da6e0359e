"""One front door, two backends, three workloads:
``repro_torch.api.ElasticEngine`` (the PyTorch port's twin of
``examples/elastic_matmat.py``).

The same ``EngineConfig`` + ``Policy`` + availability trace drives

1. ``backend="simulate"``: the batched analytical path, completion-time
   distributions per churn step, no device touched;
2. ``backend="device"``: live execution of ``Y = X @ W`` on the card (the
   blocked ``usec_matvec`` kernel; ``--device cpu`` its plain version),
   bit-exact against a float64 host reference at every step, under churn
   and one forced straggler per step;
3. a ``MapReduceRows`` workload (per-row squared norm, global sum) on the
   same elastic machinery.

The executor is built once across membership changes (asserted).

Run:  PYTHONPATH=src python examples_torch/elastic_matmat.py [--steps 6]
      [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.api import (
    ElasticEngine,
    EngineConfig,
    MapReduceRows,
    MatMat,
    Policy,
)
from repro_torch.core.elastic import scripted_trace
from repro_torch.runtime import make_exact_matrix

N_WORKERS = 4
DIM = 768      # rows of X, divisible by the placement's tile count
COLS = 8       # columns of W

# Single-machine-down churn within the first three steps.
SCRIPT = {
    0: ((3,), ()),
    1: ((1,), (3,)),
    2: ((), (1,)),
    4: ((2,), ()),
    5: ((), (2,)),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the executor runs (default: the CUDA card)")
    args = ap.parse_args(argv)

    x = make_exact_matrix(DIM, args.seed)
    rng = np.random.default_rng(args.seed + 1)
    # Grid-valued W: every partial of X @ W is exactly representable.
    w = (np.round(rng.normal(size=(DIM, COLS)) * 16) / 16).astype(np.float32)

    policy = Policy(placement="cyclic", replication=3, stragglers=1)
    cfg = EngineConfig(block_rows=16, verify="exact", n_draws=256,
                       seed=args.seed, jitter_sigma=0.2,
                       initial_speeds=(1000.0, 1300.0, 1700.0, 2200.0))
    print(f"== ElasticEngine: {N_WORKERS} workers, X ({DIM}x{DIM}) @ "
          f"W ({DIM}x{COLS}), {args.steps} steps, scripted churn ==")

    # ---- backend="simulate": the analytical sweep over the same trace ----
    sim = ElasticEngine(MatMat(w), policy, cfg, backend="simulate",
                        n_machines=N_WORKERS)
    sres = sim.run(events=scripted_trace(N_WORKERS, SCRIPT),
                   n_steps=args.steps)
    mean = float(np.mean(sres.completion_times))
    print(f"simulate | {sres.n_steps} steps x {cfg.n_draws} draws | "
          f"plans {sres.plans_compiled} (hits {sres.cache_hits}) | "
          f"waste {sres.total_waste} rows | mean completion {mean:.3f} "
          f"(matvec-row units x {COLS} cols)")

    # ---- backend="device": the same config executed live ----------------
    dev = ElasticEngine(MatMat(w), policy, cfg, backend="device",
                        n_machines=N_WORKERS, device=args.device)
    one = np.random.default_rng(args.seed + 2)
    res = dev.run(
        x, n_steps=args.steps,
        events=scripted_trace(N_WORKERS, SCRIPT),
        straggler_sets=lambda i, avail: (
            (int(one.choice(avail)),) if len(avail) > 1 else ()),
    )
    y = res.result
    ref = x.astype(np.float64) @ w.astype(np.float64)
    assert np.array_equal(y, ref), "device result diverged from X @ W"
    assert res.executor_cache_size == 1, res.executor_cache_size
    wall = sum(r.wall_s for r in res.reports)
    print(f"device   | churn {res.churn_events} | "
          f"plans {res.plans_compiled} (hits {res.cache_hits}) | "
          f"waste {res.total_waste} rows | "
          f"{len(res.reports) / wall:5.1f} steps/s | "
          f"Y == X @ W bit-exact every step | executor entries "
          f"{res.executor_cache_size}")

    # ---- MapReduceRows on the same machinery -----------------------------
    frob = MapReduceRows(
        row_fn=lambda xb, w2: torch.sum(xb.to(torch.float32) ** 2, dim=1,
                                        keepdim=True),
        reduce_fn=lambda mapped: float(mapped.sum()),
        out_cols=1,
        ref_row_fn=lambda x64, _w: np.sum(x64 ** 2, axis=1, keepdims=True),
        name="frobenius",
    )
    mr = ElasticEngine(frob, policy, cfg, backend="device",
                       n_machines=N_WORKERS, device=args.device)
    res2 = mr.run(x, n_steps=min(args.steps, 3),
                  events=scripted_trace(N_WORKERS, SCRIPT))
    expect = float(np.sum(x.astype(np.float64) ** 2))
    assert res2.result == expect, (res2.result, expect)
    print(f"mapreduce| ||X||_F^2 = {res2.result:.0f} (exact) under the same "
          f"churn | executor entries {res2.executor_cache_size}")


if __name__ == "__main__":
    main()
