#!/usr/bin/env python3
"""Find the served cell's knee: the highest offered rate the server sustains.

    python3 h100bench/sweep.py --workload serve.cyclic.poisson --seed <n> \
        --seconds <s> --rates 100,150,...

Sets the cell up once, then drives its open loop at each rate in turn for
``--seconds`` (arrivals and operands drawn from the seed, churn included)
and prints one JSON line per rate: the 50th and 95th percentile latency
from the due time, the rate answered, and the latency of the last tenth of
the arrivals against the first tenth (a backlog that grows through the
window shows as a ratio well above 1). The knee is the highest rate whose
backlog does not grow; the cell's mix runs at four fifths of it.
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


def main() -> int:
    from h100bench.harness import bench
    from h100bench.harness.main import cache_dirs

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="serve.cyclic.poisson")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--rates", required=True)
    a = p.parse_args()
    cache_dirs()
    cell = bench.cell(a.workload)
    bench.host_env(cell.cfg)

    import numpy as np
    import torch

    from h100bench.harness import data
    from h100bench.harness.churn import Churn
    from h100bench.traffic import open_loop

    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    ctx = bench.Context(cell=cell, seed=a.seed, seconds=a.seconds,
                        trace=False, device=dev, t_start=T_START)
    cfg, tr = cell.cfg, cell.traffic
    srv, pool = open_loop.setup(ctx)
    churn = Churn(cfg, tr["churn"], data.rng(a.seed, data.STREAM_CHURN))
    print(json.dumps({"setup_s": time.perf_counter() - T_START,
                      "card": torch.cuda.get_device_name(dev)}), flush=True)
    for i, rate in enumerate(float(r) for r in a.rates.split(",")):
        due, which = open_loop.arrivals(a.seed + i, rate, a.seconds,
                                        len(pool))
        out = open_loop.serve(srv, pool, due, which, churn,
                              int(tr["churn_every_windows"]), a.seconds)
        lat = out["latency_s"]
        n = len(lat)
        tenth = max(1, n // 10)
        answered = int(np.sum(~np.isnan(lat)))
        print(json.dumps({
            "rate": rate, "queries": n, "answered": answered,
            "p50_ms": 1e3 * float(np.nanpercentile(lat, 50)),
            "p95_ms": 1e3 * float(np.nanpercentile(lat, 95)),
            "answered_per_s": answered / out["wall_s"],
            "wall_s": out["wall_s"],
            "windows": len(out["polls"]),
            "mean_fill": float(np.mean([k for _, k in out["polls"]])),
            "last_over_first": float(np.nanmean(lat[-tenth:])
                                     / np.nanmean(lat[:tenth]))}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
