"""Independent clients' matvec queries against the staged matrix, open loop.

``rate_per_s`` is fixed in the mix (four fifths of the knee that
``h100bench/sweep.py`` found on the chip). Every seed sends the same number
of queries, ``rate_per_s * seconds``, at times drawn as a Poisson process
conditioned on that count (sorted uniform times over the window), each a
unit vector on the 2^-bits grid from a pool made at set-up from the seed.
One loop submits each query when it is due, feeds one churn draw before
every ``churn_every_windows``-th dispatching poll (the served engine's step)
through ``ElasticServer.feed_event``, and polls the server;
a query's latency runs from its due time to the return of the poll that
answered it, so time the loop spent inside a dispatch counts against every
query that fell due meanwhile. After the arrivals end the loop waits, at
most a minute, for the last answers. Every answer is judged after the
window (:func:`check`).
"""

from __future__ import annotations

import gc

import time

import numpy as np
import torch

from h100bench.harness import data, reference, trace
from h100bench.harness.churn import Churn

TRACE_SECONDS = 3.0
GRACE_S = 60.0


def _pool(ctx) -> np.ndarray:
    """(P, D) float32 operands: normal draws snapped to the grid."""
    cfg, tr = ctx.cell.cfg, ctx.cell.traffic
    dim, p = int(cfg["matrix_size"]), int(tr["operand_pool"])
    raw = data.rng(ctx.seed, data.STREAM_OPERANDS).standard_normal(
        (dim, p), dtype=np.float32)
    q = reference.quantize_unit(torch.from_numpy(raw),
                                int(cfg["quantize_bits"]))
    return np.ascontiguousarray(q.numpy().T)


def arrivals(seed: int, rate: float, seconds: float, pool: int):
    """Due times (s from the window's start, sorted) and pool indices."""
    n = int(round(rate * seconds))
    r = data.rng(seed, data.STREAM_ARRIVALS)
    return np.sort(r.uniform(0.0, seconds, n)), r.integers(0, pool, n)


def _server(ctx, x):
    from repro_torch.api import EngineConfig, Policy
    from repro_torch.runtime import SyntheticSpeedClock
    from repro_torch.serve import ElasticServer, ServeConfig

    cfg = ctx.cell.cfg
    speeds = [float(s) * float(cfg["rows_per_second"])
              for s in cfg["speeds"]]
    return ElasticServer(
        x,
        Policy(placement=cfg["placement"],
               replication=int(cfg["replication"]),
               stragglers=int(cfg["stragglers"])),
        EngineConfig(block_rows=int(cfg["block_rows"]),
                     segmented=cfg["segmented"]),
        ServeConfig(batch_cols=int(cfg["serve"]["batch_cols"]),
                    max_queue=int(cfg["serve"]["max_queue"])),
        engine_clock=SyntheticSpeedClock(
            speeds, jitter_sigma=float(cfg["jitter_sigma"]),
            seed=data.sub_seed(ctx.seed, data.STREAM_CLOCK)),
        n_machines=int(cfg["n_machines"]),
        device=ctx.device,
    )


def serve(srv, pool, due, which, churn, churn_every, seconds, sl=None,
          launches=None):
    """Drive one open-loop window; ``churn_every`` windows a churn draw.
    Returns the window's record (answers kept as the server returned
    them)."""
    n = len(due)
    lat = np.full(n, np.nan)
    answers = [None] * n
    # Answers are copied into a buffer made and touched (its pages written)
    # before the window, so keeping them changes nothing of how the program
    # allocates and takes no page fault inside it.
    store = np.empty((n, len(pool[0])), dtype=np.float32)
    store.fill(0.0)
    owner = {}
    polls = []
    lag = np.zeros(n)
    rejected = failed = 0
    i = 0
    dispatched = 0
    traced = None
    l0 = launches() if launches else 0
    t0 = time.perf_counter()
    if sl is not None:
        sl.start()
    done = 0
    while done + rejected + failed < n:
        now = time.perf_counter() - t0
        if now > seconds + GRACE_S:
            break
        while i < n and due[i] <= now:
            with torch.profiler.record_function("bench.submit"):
                tk = srv.submit("matvec", pool[which[i]])
            lag[i] = now - due[i]
            if tk.admitted:
                owner[tk.rid] = i
            else:
                rejected += 1
            i += 1
        if srv.queue_depth == 0:
            if i < n:
                time.sleep(max(0.0, due[i] - (time.perf_counter() - t0)))
            continue
        if churn is not None and dispatched % churn_every == 0:
            pre, arr = churn.draw()
            srv.feed_event(preempted=pre, arrived=arr)
        dispatched += 1
        tp = time.perf_counter()
        with torch.profiler.record_function("bench.poll"):
            resp = srv.poll()
        tq = time.perf_counter()
        ok = 0
        for r in resp:
            q = owner.pop(r.rid)
            if r.status == "ok":
                lat[q] = tq - t0 - due[q]
                np.copyto(store[q], r.result)
                answers[q] = store[q]
                ok += 1
            else:
                failed += 1
        done += ok
        if resp:
            polls.append((tq - tp, ok))
        if sl is not None and traced is None and tq - t0 >= TRACE_SECONDS:
            sl.stop()
            traced = {"windows": len(polls),
                      "launches": {"segmented_kernel":
                                   (launches() - l0) if launches else 0}}
    wall = time.perf_counter() - t0
    if sl is not None and traced is None:
        sl.stop()
        traced = {"windows": len(polls),
                  "launches": {"segmented_kernel":
                               (launches() - l0) if launches else 0}}
    return {"latency_s": lat, "answers": answers, "polls": polls,
            "rejected": rejected, "failed": failed, "wall_s": wall,
            "lag_s": lag, "traced": traced}


def setup(ctx):
    """The server on X from the seed, the operand pool, and warm-up: full
    windows, the only operand width the lane runs. Returns (server,
    pool)."""
    cfg, tr = ctx.cell.cfg, ctx.cell.traffic
    x = data.make_matrix(cfg, ctx.seed, ctx.device).cpu().numpy()
    srv = _server(ctx, x)
    del x
    pool = _pool(ctx)
    cols = int(cfg["serve"]["batch_cols"])
    for k in range(int(tr["warmup_windows"])):
        for c in range(cols):
            srv.submit("matvec", pool[(k + c) % len(pool)])
        while srv.queue_depth:
            srv.poll()
    return srv, pool


def run(ctx) -> dict:
    from repro_torch.kernels.usec_segmented import usec_segmented_cuda

    cfg, tr = ctx.cell.cfg, ctx.cell.traffic
    srv, pool = setup(ctx)
    due, which = arrivals(ctx.seed, float(tr["rate_per_s"]), ctx.seconds,
                          len(pool))
    cols = int(cfg["serve"]["batch_cols"])
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
        if ctx.trace:
            trace.warm_profiler()
    churn = Churn(cfg, tr["churn"], data.rng(ctx.seed, data.STREAM_CHURN))
    sl = trace.Slice(ctx.device) if ctx.trace else None
    gc.collect()
    gc.disable()
    setup_s = time.perf_counter() - ctx.t_start
    out = serve(srv, pool, due, which, churn, int(tr["churn_every_windows"]),
                ctx.seconds, sl=sl,
                launches=lambda: usec_segmented_cuda.launches)
    gc.enable()
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    rec = {
        "kind": "serve",
        "setup_s": setup_s,
        "window_s": ctx.seconds,
        "queries": len(due),
        "limit_ms": float(tr["latency_limit_ms"]),
        "batch_cols": cols,
        "memory_peak_bytes": int(peak),
        "dim": int(cfg["matrix_size"]),
        "copies": 1 + int(cfg["stragglers"]),
        "which": which,
        "pool": pool,
        "trace": None,
        **out,
    }
    del srv
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    if sl is not None:
        rec["trace"] = dict(sl.reduce(), **out["traced"])
    return rec


def check(ctx, rec, matmul=None) -> dict:
    """Every answer against ``X @ w`` in float64; a query never answered
    counts as failed."""
    cfg = ctx.cell.cfg
    x = data.make_matrix(cfg, ctx.seed, ctx.device, torch.float64)
    pool = torch.as_tensor(rec["pool"].T, device=ctx.device)
    ref = reference.answers(x, pool, matmul=matmul)          # (D, P)
    del x
    got = [q for q, a in enumerate(rec["answers"]) if a is not None]
    gap = 0.0
    wrong = 0
    for c0 in range(0, len(got), 256):
        part = got[c0:c0 + 256]
        a = torch.as_tensor(np.stack([rec["answers"][q] for q in part],
                                     axis=1), device=ctx.device)
        want = ref[:, torch.as_tensor(rec["which"][part],
                                      device=ctx.device)]
        g = (a.to(torch.float64) - want).abs().amax(0)
        wrong += int((g > 0).sum())
        gap = max(gap, float(g.max()))
    unanswered = rec["queries"] - len(got)
    return {"checks": {"answer_gap": gap, "unanswered": float(unanswered)},
            "attempted": rec["queries"], "failed": wrong + unanswered}


