"""Back-to-back power-iteration jobs through ``ElasticEngine.run``.

The paper's Sec. V application as a user runs it: job after job, each
``steps_per_job`` iterations of ``y = X @ w`` from its own starting vector,
on one staged matrix, while the fleet churns. The churn is one Markov draw a
step, continued across jobs; with ``forced_stragglers`` each step masks that
many members drawn from the seed.

Set-up: X made on the card from the seed and handed to the engine as the
host array it takes; the engine stages it; ``warmup_jobs`` jobs run
(kernel build or load, the plan cache, streams). The window then runs whole
jobs until ``seconds`` have passed; its wall over its iterations is the
iteration time. Every iterate of every window job is kept and judged after
the window (:func:`check`).
"""

from __future__ import annotations

import gc
import json
import math
import time

import numpy as np
import torch

from h100bench.harness import data, reference, roofline, trace
from h100bench.harness.churn import Churn

TRACE_SECONDS = 3.0      # the traced slice at the window's start
CHECK_COLUMNS = 256      # jobs the reference advances at once


def _engine(ctx, x):
    from repro_torch.api import (
        ElasticEngine,
        EngineConfig,
        MatVecPowerIteration,
        Policy,
    )
    from repro_torch.runtime import SyntheticSpeedClock

    cfg, tr = ctx.cell.cfg, ctx.cell.traffic

    class Recording(MatVecPowerIteration):
        """The paper's power iteration, copying each step's combined ``y``
        into the harness's buffer (when one is set) or keeping it."""

        buf = None
        used = 0

        def reset(self):
            super().reset()
            self.ys = []

        def combine(self, partials):
            if self.buf is not None and self.used < len(self.buf):
                row = self.buf[self.used]
                np.copyto(row, partials)
                self.used += 1
                self.ys.append(row)
            else:
                self.ys.append(np.array(partials, copy=True))
            return partials

    wl = Recording(quantize_bits=int(cfg["quantize_bits"]))
    speeds = [float(s) * float(cfg["rows_per_second"])
              for s in cfg["speeds"]]
    eng = ElasticEngine(
        wl,
        Policy(placement=cfg["placement"],
               replication=int(cfg["replication"]),
               stragglers=int(cfg["stragglers"])),
        EngineConfig(block_rows=int(cfg["block_rows"]),
                     segmented=cfg["segmented"], arrival=tr["arrival"],
                     fuse_steps=int(tr.get("fuse_steps", 1))),
        backend="device", n_machines=int(cfg["n_machines"]),
        clock=SyntheticSpeedClock(
            speeds, jitter_sigma=float(cfg["jitter_sigma"]),
            seed=data.sub_seed(ctx.seed, data.STREAM_CLOCK)),
        device=ctx.device,
    )
    eng.prepare(x)
    return eng, wl


def _events(ctx):
    from repro_torch.core.elastic import ElasticEvent

    churn = Churn(ctx.cell.cfg, ctx.cell.traffic["churn"],
                  data.rng(ctx.seed, data.STREAM_CHURN))
    step = 0
    while True:
        pre, arr = churn.draw()
        step += 1
        yield ElasticEvent(step=step, preempted=pre, arrived=arr,
                           available=tuple(sorted(churn.available)))


def _stragglers(ctx):
    k = int(ctx.cell.traffic.get("forced_stragglers", 0))
    if not k:
        return None
    r = data.rng(ctx.seed, data.STREAM_STRAGGLERS)

    def pick(step, membership):
        mem = sorted(membership)
        if len(mem) <= k:
            return ()
        return tuple(int(m) for m in r.choice(mem, size=k, replace=False))

    return pick


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(ctx) -> dict:
    from repro_torch.kernels.usec_segmented import usec_segmented_cuda

    cfg, tr = ctx.cell.cfg, ctx.cell.traffic
    dim = int(cfg["matrix_size"])
    steps = int(tr["steps_per_job"])
    warm = int(tr["warmup_jobs"])
    x = data.make_matrix(cfg, ctx.seed, ctx.device).cpu().numpy()
    eng, wl = _engine(ctx, x)
    del x
    events = _events(ctx)
    strag = _stragglers(ctx)
    # Starting vectors: warm-up jobs first, then the window's; a window
    # faster than 1 ms an iteration draws more as it goes.
    n_pre = warm + math.ceil(ctx.seconds / (steps * 1e-3))
    w0 = data.job_operands(ctx.seed, n_pre, dim)

    def job(j):
        op = (w0[j] if j < n_pre
              else data.job_operands(ctx.seed, 1, dim, first=j)[0])
        return eng.run(None, n_steps=steps, events=events, operand=op,
                       straggler_sets=strag)

    for j in range(warm):
        job(j)
    # The window's outputs are copied into buffers made and touched (their
    # pages written) here, so keeping them changes nothing of how the
    # program allocates and takes no page fault inside the window. Sized
    # for steps at the bytes bound of the rows they read.
    least_s = 1e-3 * roofline.bound_ms(*roofline.segmented_work(
        dim, 1 + int(cfg["stragglers"]), 1))[0]
    wl.buf = np.empty((math.ceil(ctx.seconds / least_s) + steps, dim),
                      dtype=np.float32)
    vecs = np.empty((len(wl.buf) // steps + 1, dim), dtype=np.float32)
    wl.buf.fill(0.0)
    vecs.fill(0.0)
    _sync(ctx.device)
    if ctx.trace and ctx.device.type == "cuda":
        trace.warm_profiler()
    gc.collect()
    gc.disable()   # no collector pause inside the window

    runner = eng.runner
    counters0 = (runner.plans_compiled, runner.cache_hits,
                 runner.churn_events, runner.precompile_s)
    jobs, steps_rec = [], []
    sl = trace.Slice(ctx.device) if ctx.trace else None
    traced = None
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    if sl is not None:
        sl.start()
        launches0 = usec_segmented_cuda.launches
    j = warm
    while True:
        with torch.profiler.record_function("bench.job"):
            res = job(j)
        r = res.result
        v = vecs[len(jobs)] if len(jobs) < len(vecs) else np.empty(dim,
                                                                   np.float32)
        np.copyto(v, r.eigvec)
        jobs.append({"index": j, "ys": wl.ys, "residuals": list(r.residuals),
                     "eigval": float(r.eigval), "eigvec": v})
        steps_rec.extend((rep.wall_s, rep.replan_s, rep.modeled_completion)
                         for rep in res.reports)
        j += 1
        now = time.perf_counter()
        if sl is not None and traced is None and now - t0 >= TRACE_SECONDS:
            sl.stop()
            traced = {"iterations": len(jobs) * steps,
                      "launches": {"segmented_kernel":
                                   usec_segmented_cuda.launches - launches0}}
        if now - t0 >= ctx.seconds:
            break
    _sync(ctx.device)
    t1 = time.perf_counter()
    gc.enable()
    if sl is not None and traced is None:
        sl.stop()
        traced = {"iterations": len(jobs) * steps,
                  "launches": {"segmented_kernel":
                               usec_segmented_cuda.launches - launches0}}
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    counters = [a - b for a, b in zip(
        (runner.plans_compiled, runner.cache_hits, runner.churn_events,
         runner.precompile_s), counters0)]
    walls = np.array([s[0] for s in steps_rec])
    plans = np.array([s[1] for s in steps_rec])
    ctx.log("window " + json.dumps({
        "iterations": len(steps_rec), "window_s": t1 - t0,
        "executor_wall_s": float(walls.sum()),
        "replan_s": float(plans.sum()),
        "replans_over_2ms": int((plans > 2e-3).sum()),
        "plans_compiled": counters[0], "cache_hits": counters[1],
        "churn_events": counters[2], "precompile_s": counters[3]}))
    del runner
    rec = {
        "kind": "powerit",
        "setup_s": setup_s,
        "window_s": t1 - t0,
        "iterations": len(jobs) * steps,
        "jobs": len(jobs),
        "steps": steps_rec,
        "memory_peak_bytes": int(peak),
        "dim": dim,
        "copies": 1 + int(cfg["stragglers"]),
        "outputs": jobs,
        "trace": None,
    }
    del eng, wl, res, r
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    if sl is not None:
        rec["trace"] = dict(sl.reduce(), **traced)
    return rec


def check(ctx, rec, matmul=None) -> dict:
    """Every window iterate against the reference: returns the compared
    numbers (``checks``), the iterations attempted and failed. ``matmul``
    replaces the reference's float64 product (the control)."""
    cfg, tr = ctx.cell.cfg, ctx.cell.traffic
    dim, steps = int(cfg["matrix_size"]), int(tr["steps_per_job"])
    bits = int(cfg["quantize_bits"])
    x = data.make_matrix(cfg, ctx.seed, ctx.device, torch.float64)
    jobs = rec["outputs"]
    y_gap = eigvec_gap = lam_gap = res_gap = 0.0
    failed = 0
    for c0 in range(0, len(jobs), CHECK_COLUMNS):
        part = jobs[c0:c0 + CHECK_COLUMNS]
        w0 = torch.as_tensor(np.stack(
            [data.job_operands(ctx.seed, 1, dim, first=jb["index"])[0]
             for jb in part], axis=1), device=ctx.device)
        ref = reference.power_iteration(x, w0, steps, bits, matmul=matmul)
        for t in range(steps):
            y = torch.as_tensor(np.stack([jb["ys"][t] for jb in part],
                                         axis=1), device=ctx.device)
            gap = (y.to(torch.float64) - ref["y"][t]).abs().amax(0)
            failed += int((gap > 0).sum())
            y_gap = max(y_gap, float(gap.max()))
        v = torch.as_tensor(np.stack([jb["eigvec"] for jb in part], axis=1),
                            device=ctx.device)
        eigvec_gap = max(eigvec_gap, float(
            (v.to(torch.float64) - ref["eigvec"].to(torch.float64))
            .abs().max()))
        lam = ref["eigval"][-1].cpu().numpy()
        lam_gap = max(lam_gap, reference.rel_gap(
            [jb["eigval"] for jb in part], lam))
        res_ref = torch.stack(ref["residual"], 1).cpu().numpy()   # (J, T)
        res_gap = max(res_gap, reference.max_abs_gap(
            [jb["residuals"] for jb in part], res_ref))
    del x
    return {"checks": {"y_gap": y_gap, "eigvec_gap": eigvec_gap,
                       "eigval_rel_gap": lam_gap, "residual_gap": res_gap},
            "attempted": rec["iterations"],
            "failed": failed}
