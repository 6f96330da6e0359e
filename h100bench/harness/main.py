"""One run of one cell: set-up, the measured window, the check, the line.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks`` (each number compared, with its limit).
The compared numbers are also the last lines of standard error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

from h100bench.harness import bench, guard


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    The program's kernels build into ``build/kernels`` there by
    themselves."""
    build = bench.ROOT / "build"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)


def judge(checks: dict, limits: dict):
    """``correct`` and the compared numbers beside their limits. A number
    with no limit in the cell's file is a fault of the cell's files."""
    out = {}
    ok = True
    for name, value in checks.items():
        lim = limits[name]["limit"]
        out[name] = {"value": value, "limit": lim}
        ok = ok and value <= lim
    return ok, out


def execute(cell: bench.Cell, seed: int, seconds: float, trace: bool,
            device, t_start: float, bench_json: dict, log=None) -> dict:
    """Set-up, window, check and metrics of one run on ``device``; returns
    the result object (without printing). The caller has already checked
    for the cards the cell needs."""
    import torch

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    ctx = bench.Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                        device=device, t_start=t_start, log=log)
    gen = bench.generator(cell.traffic)
    rec = gen.run(ctx)
    bad = guard.forbidden_loaded()
    if bad:
        raise RuntimeError(f"modules of JAX or the JAX package loaded: {bad}")
    t_check = time.perf_counter()
    verdict = gen.check(ctx, rec)
    log(f"check_s {time.perf_counter() - t_check:.3f}")
    correct, checks = judge(verdict["checks"], cell.limits)
    metrics = {}
    for m in bench.metrics_for(bench_json, cell.name, trace):
        value = bench.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": rec["memory_peak_bytes"]}
    out = {"correct": bool(correct), "attempted": int(verdict["attempted"]),
           "failed": int(verdict["failed"]), "metrics": metrics,
           "device": dev}
    if trace and rec.get("trace"):
        tr = rec["trace"]
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["checks"] = checks
    return out


def main(argv: Optional[List[str]] = None, t_start: Optional[float] = None
         ) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    cache_dirs()
    bench_json = bench.benchmark()
    cell = bench.cell(args.workload, bench_json)
    bench.host_env(cell.cfg)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"h100bench: {args.workload} needs {cell.chips} CUDA "
              f"device(s), found {have}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    out = execute(cell, args.seed, args.seconds, bool(args.trace), device,
                  t_start, bench_json)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
