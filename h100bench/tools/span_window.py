#!/usr/bin/env python3
"""One benchmark cell's window with a span Recorder over all of it (the
profiler off), or the tracing gate's cost on this host.

    python3 h100bench/tools/span_window.py --workload <cell> --seed <n> \
        --seconds <s> [--device cuda:0]
    python3 h100bench/tools/span_window.py --gate

The cell runs as ``h100bench/run.py --trace 1`` runs it, except that the
generator's traced slice (``trace.Slice``) is replaced by a
``repro_torch.runtime.tracing.Recorder`` started at the window's start and
stopped after its end, so no profiler runs. Prints one JSON line: the
window's own numbers (``iter_ms`` or ``query_p95_ms``) beside what the
program's spans say of it. Power-iteration cells: ``engine_run_cover``
(the ``engine.run`` spans over the window's wall), ``runner.host_ms``
(an ``engine.step`` less its ``runner.dispatch``), ``runner.solve_share``
(steps whose ``runner.adopt`` holds a ``runner.probe`` or
``runner.solve``, %), ``runner.update_ms`` (``workload.update`` a step),
``executor.dispatch_ms`` (``runner.dispatch`` a step),
``ingest_plus_adopt_ms`` (to hold against ``runner.replan_ms``) and each
span's self ms a step. The served cell: ``serve.queue_wait_ms`` (the
nearest-rank p95 of ``serve.queued``), ``serve.host_ms`` (a dispatching
``serve.poll`` less its ``runner.dispatch``),
``serve.device_allocs_per_window`` (the allocator's ``num_device_alloc``
over the window, per dispatched window) and each span's self ms a window.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for _p in (os.path.join(_ROOT, "src"), _ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def gate():
    import timeit

    import torch  # noqa: F401  (the profiler module the gate reads)

    from repro_torch.runtime import tracing

    n = 1_000_000

    def off():
        with tracing.span("runner.step", 1):
            pass

    t_off = min(timeit.repeat(off, number=n, repeat=5)) / n
    t_flag = min(timeit.repeat(
        lambda: tracing.span("runner.step", 1),
        number=n, repeat=5)) / n
    rec = tracing.Recorder().start()
    m = 200_000
    t_on = min(timeit.repeat(off, number=m, repeat=3)) / m
    rec.stop()
    stamp = min(timeit.repeat(tracing.stamp, number=n, repeat=3)) / n
    return {"off_span_us": 1e6 * t_off, "gate_us": 1e6 * t_flag,
            "recorded_span_us": 1e6 * t_on, "stamp_us": 1e6 * stamp}


class RecSlice:
    """Stands in for ``trace.Slice``: a Recorder from the window's start to
    the record's reduction after the window."""

    def __init__(self, device):
        from repro_torch.runtime.tracing import Recorder

        self.rec = Recorder()

    def start(self):
        self.rec.start()

    def stop(self):
        pass

    def reduce(self):
        self.rec.stop()
        return {}


def children(spans):
    kids = [[] for _ in spans]
    for i, s in enumerate(spans):
        if s[2] is not None:
            kids[s[2]].append(i)
    return kids


def dur(s):
    return 1e-9 * (s[4] - s[3])


def inside(spans, kids, i, name):
    """Seconds of ``name`` spans anywhere below span ``i``."""
    out, todo = 0.0, list(kids[i])
    while todo:
        k = todo.pop()
        if spans[k][0] == name:
            out += dur(spans[k])
        else:
            todo.extend(kids[k])
    return out


def holds(spans, kids, i, names):
    todo = list(kids[i])
    while todo:
        k = todo.pop()
        if spans[k][0] in names:
            return True
        todo.extend(kids[k])
    return False


def powerit(rec, r, window_s):
    spans = r.spans
    kids = children(spans)
    steps = [i for i, s in enumerate(spans) if s[0] == "engine.step"]
    runs = [i for i, s in enumerate(spans) if s[0] == "engine.run"]
    summ = r.summary()["spans"]
    n = len(steps)
    disp = [inside(spans, kids, i, "runner.dispatch") for i in steps]
    host = [dur(spans[i]) - d for i, d in zip(steps, disp)]
    adopts = [i for i, s in enumerate(spans) if s[0] == "runner.adopt"]
    solved = sum(holds(spans, kids, i, ("runner.probe", "runner.solve"))
                 for i in adopts)
    ingest = summ.get("runner.ingest", {}).get("total_s", 0.0)
    adopt = summ.get("runner.adopt", {}).get("total_s", 0.0)
    plans = [s[1] for s in rec["steps"]]
    return {
        "iter_ms": 1e3 * rec["window_s"] / rec["iterations"],
        "iterations": rec["iterations"],
        "runner.replan_ms": 1e3 * sum(plans) / len(plans),
        "engine_run_cover": sum(dur(spans[i]) for i in runs) / window_s,
        "ingest_plus_adopt_ms": 1e3 * (ingest + adopt) / n,
        "runner.host_ms": 1e3 * sum(host) / n,
        "runner.solve_share": 100.0 * solved / n,
        "runner.update_ms": 1e3 * summ["workload.update"]["total_s"] / n,
        "executor.dispatch_ms": 1e3 * sum(disp) / n,
        "engine_steps": n,
        "self_ms_per_step": {k: 1e3 * v["self_s"] / n
                             for k, v in sorted(summ.items())},
        "count_per_step": {k: v["count"] / n
                           for k, v in sorted(summ.items())},
    }


def serve(rec, r):
    import numpy as np

    spans = r.spans
    kids = children(spans)
    polls = [i for i, s in enumerate(spans) if s[0] == "serve.poll"
             and holds(spans, kids, i, ("serve.dispatch",))]
    n = len(polls)
    host = [dur(spans[i]) - inside(spans, kids, i, "runner.dispatch")
            for i in polls]
    q = np.sort([1e-9 * (a[4] - a[3]) for a in r.async_spans
                 if a[0] == "serve.queued"])
    summ = r.summary()
    lat = np.sort(np.where(np.isnan(rec["latency_s"]), np.inf,
                           rec["latency_s"]))
    return {
        "query_p95_ms": 1e3 * float(lat[math.ceil(0.95 * len(lat)) - 1]),
        "windows": n,
        "serve.queue_wait_ms": 1e3 * float(q[math.ceil(0.95 * len(q)) - 1]),
        "serve.host_ms": 1e3 * sum(host) / n,
        "serve.device_allocs_per_window":
            summ["counters"]["num_device_alloc"] / n,
        "serve.poll_ms_outside": 1e3 * sum(w for w, _ in rec["polls"])
        / len(rec["polls"]),
        "self_ms_per_window": {k: 1e3 * v["self_s"] / n
                               for k, v in sorted(summ["spans"].items())},
        "count_per_window": {k: v["count"] / n
                             for k, v in sorted(summ["spans"].items())},
    }


def run(cell, seed: int, seconds: float, device,
        t_start: float = None, log=None) -> dict:
    """One window of ``cell`` on ``device`` under a Recorder: the JSON
    line's fields, ``correct`` as the benchmark judges it."""
    from h100bench.harness import bench, main as hmain, trace

    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    gen = bench.generator(cell.traffic)
    made = []

    def slice_(dev):
        made.append(RecSlice(dev))
        return made[-1]

    saved = trace.Slice, trace.warm_profiler
    trace.Slice, trace.warm_profiler = slice_, (lambda: None)
    try:
        ctx = bench.Context(cell=cell, seed=seed, seconds=seconds,
                            trace=True, device=device, t_start=t_start,
                            log=log)
        rec = gen.run(ctx)
    finally:
        trace.Slice, trace.warm_profiler = saved
        for s in made:
            s.rec.stop()
    r = made[0].rec
    import torch

    out = {"workload": cell.name, "seed": seed,
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else device.type)}
    if rec["kind"] == "powerit":
        out.update(powerit(rec, r, rec["window_s"]))
    else:
        out.update(serve(rec, r))
    verdict = gen.check(ctx, rec)
    ok, _ = hmain.judge(verdict["checks"], cell.limits)
    out["correct"] = bool(ok)
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload")
    p.add_argument("--seed", type=int)
    p.add_argument("--seconds", type=float)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--gate", action="store_true")
    a = p.parse_args()
    if a.gate:
        print(json.dumps(gate()), flush=True)
        return 0
    from h100bench.harness import bench, main as hmain

    hmain.cache_dirs()
    cell = bench.cell(a.workload, bench.benchmark())
    bench.host_env(cell.cfg)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = run(cell, a.seed, a.seconds, torch.device(a.device), T_START)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
