#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

It builds the hand-written kernels from src/repro_torch/csrc with nvcc (into
build/kernels/), holds each kernel against its plain PyTorch version on the
card, then drives the paper's Sec. V experiment through the normal front
door, ``ElasticEngine(MatVecPowerIteration, backend="device")``: N = 6
workers, J = 3, a 6000 x 6000 integer-valued matrix, cyclic and MAN
placements at S in {0, 1}, scripted churn, 8 steps, ``verify="exact"`` at
every step, in both executor modes (per-block ``usec_matvec`` and one
``usec_segmented`` launch a step). Then the model stack's serving path:
the flash-attention kernel against its plain version (the JAX tests' cases,
every head_dim, one full-width glm4-9b layer), glm4-9b at full width with
random weights through ``repro_torch.launch.serve.generate`` (an 8192-token
prompt, 32 greedy decode steps; one kernel launch per prefill layer, none
in decode), a profiled prefill + decode, and card-vs-host parity at reduced
size. Every phase prints one JSON line; the
line before the last lists every kernel with its launches on the main path,
its time, its bound and its plain version's time; the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero,
and without a CUDA device it exits non-zero before printing a result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 outside the
# tensor cores, bf16 on the tensor cores. The kernels compute in fp32 FFMA;
# a kernel's bound uses the peak for its inputs' type.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

N_WORKERS, REPLICATION, DIM, BLOCK_ROWS, STEPS = 6, 3, 6000, 20, 8
BASE_SPEEDS = [1000.0, 2000.0, 4000.0, 8000.0, 16000.0, 32000.0]
# Single-machine-down states only (every placement keeps all tiles and
# S = 1 stays feasible); preemption and arrival both land early.
SCRIPT = {0: ((5,), ()), 1: ((1,), (5,)), 2: ((), (1,)), 4: ((3,), ()),
          5: ((), (3,))}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(n_bytes: float, n_flops: float,
             flops_per_s: float = FP32_FLOPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_flops / flops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_times(fn, iters: int):
    """Device-side time of ``iters`` calls of ``fn`` from torch.profiler's
    CUPTI trace: {kernel / memcpy name: (total_us, count)}. CPU ops are left
    out, since their device time is their kernels' time again."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or 0
        if us > 0 and str(ev.device_type).endswith("CUDA"):
            out[ev.key] = (float(us), int(ev.count))
    return out


def device_ms(fn, iters: int, tag: str = ""):
    """Mean device ms per call of ``fn``, over the device entries whose
    name contains ``tag`` (all of them by default); None when the trace
    shows none."""
    hits = [v for k, v in device_times(fn, iters).items() if tag in k]
    if not hits:
        return None
    return 1e-3 * sum(h[0] for h in hits) / iters


def rel_err(got, want) -> float:
    scale = float(want.abs().max()) or 1.0
    return float((got.float() - want.float()).abs().max()) / scale


def grid_operands(rng, shape_x, k, c, dev):
    """Integer X and a 2^-4 grid W: every partial sum is exact in fp32."""
    x = torch.as_tensor(rng.integers(-3, 4, size=shape_x).astype(np.float32),
                        device=dev)
    w = torch.as_tensor((rng.integers(-8, 9, size=(k, c)) / 16.0)
                        .astype(np.float32), device=dev)
    return x, w


def timed(fn, iters: int, tag: str = ""):
    """A call's time: device time from the profiler's trace (``ms``), and
    the CUDA-event time of back-to-back calls, which includes the host's
    dispatch (``dispatch_ms``). Where the trace shows no device entry the
    event time stands in, and ``ms_source`` says so."""
    dispatch = cuda_ms(fn, iters)
    dev = device_ms(fn, iters, tag)
    if dev is None:
        return {"ms": dispatch, "ms_source": "cuda_events",
                "dispatch_ms": dispatch}
    return {"ms": dev, "ms_source": "profiler", "dispatch_ms": dispatch}


def phase_kernels(dev):
    from repro_torch.core import USECScheduler, make_placement
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import matvec_ref
    from repro_torch.kernels.usec_matvec import usec_matvec_cuda
    from repro_torch.kernels.usec_segmented import (
        segmented_plain,
        usec_segmented_cuda,
    )
    from repro_torch.runtime import (
        block_plan,
        device_plan,
        make_exact_matrix,
        stage_matrix,
    )

    rng = np.random.default_rng(0)
    rows = []

    # ---- usec_matvec: one main-path block is (20, 6000) @ (6000, 1) ----
    for k_dim in (DIM, 517):
        for c in (1, 3, 128):
            for m in (BLOCK_ROWS, 300):
                # X as a strided view of a wider buffer, like a staged block
                # (16-byte aligned rows at K = 6000, unaligned at K = 517).
                xs, w = grid_operands(rng, (m, k_dim + 8), k_dim, c,
                                      dev)
                x = xs[:, 4: 4 + k_dim]
                exact = bool(torch.equal(usec_matvec_cuda(x, w),
                                         matvec_ref(x, w)))
                xn = torch.randn((m, k_dim), device=dev)
                wn = torch.randn((k_dim, c), device=dev)
                e32 = rel_err(usec_matvec_cuda(xn, wn), matvec_ref(xn, wn))
                xb = xn.to(torch.bfloat16)
                ebf = rel_err(usec_matvec_cuda(xb, wn), matvec_ref(xb, wn))
                ok = exact and e32 <= 1e-5 and ebf <= 2e-2
                rows.append(("usec_matvec", (m, k_dim, c), exact, e32, ebf))
                if not ok:
                    raise AssertionError(
                        f"usec_matvec disagrees at M={m} K={k_dim} C={c}: "
                        f"bitwise={exact} fp32 rel={e32} bf16 rel={ebf}")
    xw, ww = grid_operands(rng, (BLOCK_ROWS, DIM), DIM, 300, dev)
    if not torch.equal(ops.usec_matmat(xw, ww), matvec_ref(xw, ww)):
        raise AssertionError("usec_matmat (128-column chunks) disagrees")

    # Time the per-block call over the distinct blocks of a Sec. V-sized
    # staged buffer (432 MB, far past L2), as one executor step meets them.
    big = torch.randn((N_WORKERS * 3000, DIM), device=dev)
    w1 = torch.randn((DIM, 1), device=dev)
    blocks = [big[i * BLOCK_ROWS: (i + 1) * BLOCK_ROWS]
              for i in range(big.shape[0] // BLOCK_ROWS)]
    out = torch.empty((BLOCK_ROWS, 1), device=dev)
    it = iter(range(10 ** 9))
    mv_err = float((usec_matvec_cuda(blocks[0], w1)
                    - matvec_ref(blocks[0], w1)).abs().max())
    mv = timed(lambda: usec_matvec_cuda(
        blocks[next(it) % len(blocks)], w1, out=out), 900, "matvec_kernel")
    mv_plain = timed(lambda: matvec_ref(
        blocks[next(it) % len(blocks)], w1), 900)
    mv_lib = timed(lambda: torch.matmul(
        blocks[next(it) % len(blocks)], w1), 900)
    mv_bound, mv_by = bound_ms(
        BLOCK_ROWS * DIM * 4 + DIM * 4 + BLOCK_ROWS * 4,
        2 * BLOCK_ROWS * DIM)
    del big, blocks
    emit({"phase": "kernel", "name": "usec_matvec",
          "cases": len(rows), "bitwise_integer_grid": True,
          "max_rel_err_fp32": max(r[3] for r in rows),
          "max_rel_err_bf16": max(r[4] for r in rows),
          "shape": [BLOCK_ROWS, DIM, 1], "kernel": mv, "plain": mv_plain,
          "library": mv_lib, "bound_us": 1e3 * mv_bound,
          "launches": usec_matvec_cuda.launches})

    # ---- usec_segmented: the Sec. V plan, every worker in one launch ----
    x = make_exact_matrix(DIM, 0)
    placement = make_placement("cyclic", N_WORKERS, N_WORKERS, REPLICATION)
    rpt = DIM // N_WORKERS
    sm = stage_matrix(x, placement, rpt)
    staged = torch.as_tensor(sm.staged, device=dev)
    b_max = max(len(z) for z in placement.storage_sets()) * rpt // BLOCK_ROWS
    seg_cases = {}
    for s_tol in (0, 1):
        sched = USECScheduler(placement, rpt, np.asarray(BASE_SPEEDS) / rpt,
                              stragglers=s_tol, row_align=BLOCK_ROWS)
        bp = block_plan(sched.plan_step(tuple(range(N_WORKERS))).plan,
                        sm.slot_of, BLOCK_ROWS, b_max=b_max)
        dp = device_plan(bp, dev)
        args = (staged, dp.slot, dp.off, dp.include, dp.n_blocks)
        for c in (1, 3, 128):
            wg = torch.as_tensor((rng.integers(-8, 9, size=(DIM, c)) / 256.0)
                                 .astype(np.float32), device=dev)
            got = usec_segmented_cuda(*args, wg, BLOCK_ROWS)
            if not torch.equal(got, segmented_plain(*args, wg, BLOCK_ROWS)):
                raise AssertionError(
                    f"usec_segmented not bitwise at S={s_tol} C={c}")
        seg_cases[s_tol] = (bp, dp)
    # Normal data, the ragged K tail, short block lists and a zero-trip
    # worker: random staged buffers with K = 517 and 6000.
    seg_errs = []
    for k_dim, c in ((DIM, 1), (517, 1), (517, 3), (DIM, 128)):
        st = torch.randn((N_WORKERS, 3, 40, k_dim), device=dev)
        nb = torch.as_tensor([0, 1, 5, 6, 3, 6], dtype=torch.int32,
                             device=dev)
        slot = torch.as_tensor(rng.integers(0, 3, size=(N_WORKERS, 6)),
                               dtype=torch.int32, device=dev)
        off = torch.as_tensor(rng.integers(0, 2, size=(N_WORKERS, 6)) * 20,
                              dtype=torch.int32, device=dev)
        inc = torch.as_tensor(rng.integers(0, 2, size=(N_WORKERS, 6)),
                              dtype=torch.float32, device=dev)
        wn = torch.randn((k_dim, c), device=dev)
        a = (st, slot, off, inc, nb, wn, BLOCK_ROWS)
        got, want = usec_segmented_cuda(*a), segmented_plain(*a)
        seg_errs.append(rel_err(got, want))
        if seg_errs[-1] > 1e-5 or bool((got[0] != 0).any()):
            raise AssertionError(
                f"usec_segmented disagrees at K={k_dim} C={c}: "
                f"rel={seg_errs[-1]}")
    bp, dp = seg_cases[0]
    wn = torch.randn((DIM, 1), device=dev)
    args = (staged, dp.slot, dp.off, dp.include, dp.n_blocks, wn, BLOCK_ROWS)
    sg_err = float((usec_segmented_cuda(*args)
                    - segmented_plain(*args)).abs().max())
    out4 = torch.empty((N_WORKERS, b_max, BLOCK_ROWS, 1), device=dev)
    sg = timed(lambda: usec_segmented_cuda(*args, out=out4), 50,
               "segmented_kernel")
    sg_plain = timed(lambda: segmented_plain(*args), 20)
    real_rows = int(bp.n_blocks.sum()) * BLOCK_ROWS
    sg_bound, sg_by = bound_ms(
        real_rows * DIM * 4 + DIM * 4 + out4.numel() * 4
        + N_WORKERS * b_max * 12 + N_WORKERS * 4,
        2 * real_rows * DIM)
    emit({"phase": "kernel", "name": "usec_segmented",
          "bitwise_integer_grid": True, "cases_c": [1, 3, 128],
          "max_rel_err_fp32": max(seg_errs), "real_rows": real_rows,
          "shape": [N_WORKERS, b_max, BLOCK_ROWS, DIM, 1],
          "kernel": sg, "plain": sg_plain, "library": None,
          "bound_us": 1e3 * sg_bound,
          "launches": usec_segmented_cuda.launches})
    return {
        "usec_matvec": {
            "route": "cuda", "source": "src/repro_torch/csrc/usec_matvec.cu",
            "replaces": "src/repro/kernels/usec_matvec.py:49",
            "max_abs_err": mv_err, **mv, "plain_ms": mv_plain["ms"],
            "bound_ms": mv_bound, "bound_by": mv_by,
            "library_ms": mv_lib["ms"]},
        "usec_segmented": {
            "route": "cuda",
            "source": "src/repro_torch/csrc/usec_segmented.cu",
            "replaces": "src/repro/kernels/usec_segmented.py:63",
            "max_abs_err": sg_err, **sg, "plain_ms": sg_plain["ms"],
            "bound_ms": sg_bound, "bound_by": sg_by, "library_ms": None},
    }


def power_iteration(dev, x, kind, replication, s_tol, segmented, n_workers,
                    speeds, script, steps, block_rows, profiler=None):
    from repro_torch.api import (
        ElasticEngine,
        EngineConfig,
        MatVecPowerIteration,
        Policy,
    )
    from repro_torch.core.elastic import scripted_trace
    from repro_torch.runtime import SyntheticSpeedClock

    rng = np.random.default_rng(1)

    def one_straggler(step, membership):
        """One forced straggler per step, drawn from the live membership."""
        return (int(rng.choice(membership)),) if len(membership) > 1 else ()

    engine = ElasticEngine(
        MatVecPowerIteration(seed=0),
        Policy(placement=kind, replication=replication, stragglers=s_tol),
        EngineConfig(block_rows=block_rows, verify="exact",
                     segmented=segmented),
        backend="device", n_machines=n_workers,
        clock=SyntheticSpeedClock(speeds, jitter_sigma=0.03, seed=0),
        device=dev,
    )
    data = x
    if profiler is not None:
        # Stage X before the trace starts: the profile covers steps only.
        engine._runner = engine._build_runner(x)
        data = None
        profiler.start()
    try:
        return engine.run(
            data, n_steps=steps, events=scripted_trace(n_workers, script),
            straggler_sets=one_straggler if s_tol else None).result
    finally:
        if profiler is not None:
            torch.cuda.synchronize()
            profiler.stop()


def phase_parity():
    """The port on the card against the port on the host (the plain
    versions, themselves held against the JAX package by the CPU tests) at
    the CPU tests' size: bitwise eigvec and residuals."""
    from repro_torch.runtime import make_exact_matrix

    x = make_exact_matrix(768, 0)
    script4 = {0: ((3,), ()), 1: ((1,), (3,)), 2: ((), (1,)),
               4: ((2,), ()), 5: ((), (2,))}
    for seg in (None, "auto"):
        res = {}
        for dev in ("cpu", "cuda"):
            res[dev] = power_iteration(
                dev, x, "man", 3, 1, seg, 4, [1000.0, 1300.0, 1700.0, 2200.0],
                script4, 6, 16)
        same = (np.array_equal(res["cpu"].eigvec, res["cuda"].eigvec)
                and res["cpu"].residuals == res["cuda"].residuals)
        if not same:
            raise AssertionError(f"card != host at segmented={seg}")
    emit({"phase": "parity", "size": [4, 768], "bitwise_card_vs_host": True})


def phase_main_path(counters):
    from repro_torch.runtime import make_exact_matrix

    x = make_exact_matrix(DIM, 0)
    totals = {name: 0 for name in counters}
    for kind in ("cyclic", "man"):
        for s_tol in (0, 1):
            outs = {}
            for seg in (None, "auto"):
                for fn in counters.values():
                    fn.launches = 0
                t0 = time.perf_counter()
                res = power_iteration(None, x, kind, REPLICATION, s_tol, seg,
                                      N_WORKERS, BASE_SPEEDS, SCRIPT, STEPS,
                                      BLOCK_ROWS)
                seconds = time.perf_counter() - t0
                launches = {n: fn.launches for n, fn in counters.items()}
                for n, v in launches.items():
                    totals[n] += v
                want = "usec_matvec" if seg is None else "usec_segmented"
                other = "usec_segmented" if seg is None else "usec_matvec"
                if launches[want] <= 0 or launches[other] != 0:
                    raise AssertionError(
                        f"{kind} S={s_tol} segmented={seg}: launches "
                        f"{launches}")
                if res.executor_cache_size != 1:
                    raise AssertionError(
                        f"executor_cache_size {res.executor_cache_size}")
                if not (np.all(np.isfinite(res.eigvec))
                        and res.eigvec.shape == (DIM,)):
                    raise AssertionError("eigvec not finite / wrong shape")
                outs[seg] = res
                emit({"phase": "main_path", "placement": kind, "S": s_tol,
                      "segmented": seg, "steps": len(res.reports),
                      "verify": "exact",
                      "steps_per_s": res.steps_per_sec,
                      "step_wall_ms": [1e3 * r.wall_s for r in res.reports],
                      "churn_events": res.churn_events,
                      "plans_compiled": res.plans_compiled,
                      "cache_hits": res.cache_hits,
                      "waste": res.total_waste,
                      "executor_cache_size": res.executor_cache_size,
                      "eigval": res.eigval,
                      "last_residual": res.residuals[-1],
                      "launches": launches,
                      "launches_per_step": launches[want] / len(res.reports),
                      "run_s": seconds})
            a, b = outs[None], outs["auto"]
            if not (np.array_equal(a.eigvec, b.eigvec)
                    and a.residuals == b.residuals):
                raise AssertionError(
                    f"{kind} S={s_tol}: per-block and segmented differ")
    return totals


def phase_profile():
    """Where a Sec. V step's time goes: the cyclic S = 0 cell in each
    executor mode under torch.profiler (X staged before the trace): the
    executor's wall per step, the device's kernel time per step, the busy
    share, and the top device entries."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime import make_exact_matrix

    x = make_exact_matrix(DIM, 0)
    for seg in (None, "auto"):
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        t0 = time.perf_counter()
        res = power_iteration(None, x, "cyclic", REPLICATION, 0, seg,
                              N_WORKERS, BASE_SPEEDS, SCRIPT, STEPS,
                              BLOCK_ROWS, profiler=prof)
        run_s = time.perf_counter() - t0
        # Device-side entries only (kernels, memcpys, memsets): a CPU op's
        # device time is its kernels' time again.
        entries = sorted(
            ((float(getattr(e, "self_device_time_total", 0) or 0), e.key,
              int(e.count)) for e in prof.key_averages()
             if str(e.device_type).endswith("CUDA")), reverse=True)
        dev_us = sum(e[0] for e in entries)
        exec_s = sum(r.wall_s for r in res.reports)
        emit({"phase": "profile", "placement": "cyclic", "S": 0,
              "segmented": seg, "steps": len(res.reports),
              "run_s_with_staging": run_s,
              "executor_wall_ms_per_step": 1e3 * exec_s / len(res.reports),
              "device_ms_per_step": 1e-3 * dev_us / len(res.reports),
              "device_busy_share_of_executor_wall":
                  (1e-6 * dev_us / exec_s) if exec_s else None,
              "top_device": [[k[:60], us, n] for us, k, n in entries[:6]
                             if us > 0]})


# ---------------------------------------------------------------------- #
# The model stack's serving path: glm4-9b prefill + decode
# ---------------------------------------------------------------------- #
MODEL_ARCH, MODEL_BATCH, PROMPT_LEN, DECODE_STEPS = "glm4-9b", 1, 8192, 32
PROFILE_DECODE_STEPS = 8
# tests/test_kernels.py's seven cases: (b, h, hk, sq, skv, d, causal,
# window, dtype).
FLASH_CASES = [
    (1, 2, 2, 128, 128, 64, True, None, torch.float32),
    (2, 4, 2, 100, 260, 64, True, None, torch.float32),
    (1, 2, 1, 64, 300, 32, False, None, torch.float32),
    (1, 2, 2, 256, 256, 64, True, 128, torch.float32),
    (1, 4, 4, 1, 384, 64, True, None, torch.float32),
    (1, 2, 2, 200, 200, 128, True, 64, torch.float32),
    (1, 2, 2, 128, 128, 64, True, None, torch.bfloat16),
]
# Every head_dim with a kernel instance, in both types; recurrentgemma's
# d = 256 with a window; queries with no live key (sq > skv, causal).
FLASH_HEAD_DIM_CASES = [
    (2, 8, 2, 300, 300, d, True, None, dt)
    for d in (32, 64, 80, 128, 256) for dt in (torch.float32, torch.bfloat16)
] + [(1, 4, 1, 300, 300, 256, True, 96, torch.bfloat16),
     (1, 4, 2, 100, 60, 64, True, None, torch.float32)]
# One glm4-9b layer's prefill attention at the model path's prompt length.
FLASH_LAYER = (1, 32, 2, PROMPT_LEN, PROMPT_LEN, 128, True, None,
               torch.bfloat16)
# (rtol, atol) of the flash kernel against an fp32 version of the same
# function. Both sides read the inputs exactly, compute in fp32 and round
# once to the output type, so they differ by the fp32 sum order and, in
# bf16, by at most one rounding step (2^-8 to 2^-7 of the value): rtol 1e-2
# is about 2.5 bf16 ulps. The atol only covers outputs near zero.
ATTN_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-2, 1e-4)}


def attn_err(got, want, live=None):
    """Max abs error of ``got`` against ``want`` over the rows ``live``
    (all by default); raises where it exceeds :data:`ATTN_TOL`."""
    rtol, atol = ATTN_TOL[got.dtype]
    err = (got.float() - want.float()).abs()
    limit = atol + rtol * want.float().abs()
    if live is not None:
        err, limit = err[live], limit[live]
    if bool((err > limit).any()):
        worst = int(torch.argmax(err - limit))
        raise AssertionError(
            f"max abs err {float(err.max())}; worst at {float(err.flatten()[worst])} "
            f"against a limit of {float(limit.flatten()[worst])}")
    return float(err.max()) if err.numel() else 0.0


def live_pairs(sq: int, skv: int, causal: bool, window) -> int:
    """(query, key) pairs the mask keeps, per (batch, head)."""
    q_pos = np.arange(sq, dtype=np.int64) + skv - sq
    hi = np.minimum(skv - 1, q_pos) if causal else np.full(sq, skv - 1)
    lo = np.maximum(0, q_pos - window + 1) if window else np.zeros(sq)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_operands(case, dev, seed):
    b, h, hk, sq, skv, d, _, _, dt = case
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dt)
            for shape in ((b, h, sq, d), (b, hk, skv, d), (b, hk, skv, d))]


def flash_check(case, dev, seed):
    """Kernel against its plain version at ``case``: within
    :data:`ATTN_TOL` on every query with a live key, exactly 0 on the others
    (the plain version gives NaN there), and bitwise equal across two runs.
    Returns the max abs error."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda,
        flash_attention_plain,
    )

    causal, window, dt = case[6], case[7], case[8]
    q, k, v = flash_operands(case, dev, seed)
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    again = flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"flash_attention not bitwise run to run at {case}")
    live = torch.isfinite(want.float()).all(dim=-1)
    if bool((got[~live] != 0).any()):
        raise AssertionError(f"flash_attention: a row with no live key is "
                             f"not 0 at {case}")
    try:
        return attn_err(got, want, live)
    except AssertionError as e:
        raise AssertionError(f"flash_attention disagrees at {case}: {e}") \
            from None


def phase_flash(dev):
    """The flash kernel against its plain version at the test cases, every
    head_dim and one full-width glm4-9b layer; then that layer's times:
    kernel, plain version, and one library call (SDPA) as a yardstick."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda,
        flash_attention_plain,
    )

    cases = FLASH_CASES + FLASH_HEAD_DIM_CASES
    errs = {str(dt).replace("torch.", ""): max(
        flash_check(c, dev, i) for i, c in enumerate(cases) if c[8] == dt)
        for dt in ATTN_TOL}
    layer_err = flash_check(FLASH_LAYER, dev, 99)
    b, h, hk, sq, skv, d, causal, window, dt = FLASH_LAYER
    q, k, v = flash_operands(FLASH_LAYER, dev, 99)
    kern = timed(lambda: flash_attention_cuda(q, k, v, causal=causal), 10,
                 "flash_kernel")
    plain = timed(lambda: flash_attention_plain(q, k, v, causal=causal), 3)
    lib = timed(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 10)
    pairs = b * h * live_pairs(sq, skv, causal, window)
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    n_flops = 4 * d * pairs
    bound, by = bound_ms(n_bytes, n_flops, BF16_FLOPS_PER_S)
    fp32_bound, _ = bound_ms(n_bytes, n_flops, FP32_FLOPS_PER_S)
    del q, k, v
    torch.cuda.empty_cache()
    emit({"phase": "kernel", "name": "flash_attention",
          "cases": len(cases) + 1, "max_abs_err_cases": errs,
          "rtol_atol": {str(dt).replace("torch.", ""): tol
                        for dt, tol in ATTN_TOL.items()},
          "bitwise_run_to_run": True, "shape": list(FLASH_LAYER[:8]),
          "dtype": "bfloat16", "max_abs_err_layer": layer_err,
          "kernel": kern, "plain": plain, "library": lib,
          "live_pairs": pairs, "flops": n_flops, "bytes": n_bytes,
          "bound_ms_bf16_tensor_core": bound,
          "bound_ms_fp32_ffma": fp32_bound,
          "kernel_tflops": n_flops / kern["ms"] / 1e9})
    return {"route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:106",
            "max_abs_err": layer_err, **kern, "plain_ms": plain["ms"],
            "bound_ms": bound, "bound_by": by, "library_ms": lib["ms"]}


def _counting(fn, tally, key):
    """``fn`` that adds the flash kernel's launches during each call to
    ``tally[key]``."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    def wrapped(*args, **kwargs):
        before = flash_attention_cuda.launches
        out = fn(*args, **kwargs)
        tally[key] += flash_attention_cuda.launches - before
        return out
    return wrapped


def phase_model_path(dev, counters, smi):
    """glm4-9b at full width through ``repro_torch.launch.serve.generate``:
    weights from a seed, an 8192-token prompt, restage, 32 greedy decode
    steps. Every prefill layer launches the flash kernel once; decode never
    does. Then one layer's prefill attention, kernel route against the
    plain ``chunked_attention``. Returns the main path's launch counts and
    what the profile phase reuses."""
    import dataclasses

    from repro_torch.configs import demo_batch, get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model, param_count
    from repro_torch.models.attention import (
        chunked_attention,
        long_attention,
        qkv,
    )
    from repro_torch.models.layers import apply_norm
    from repro_torch.models.transformer import tree_map

    cfg = get_config(MODEL_ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    bundle = build_model(cfg, device=dev)
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = demo_batch(cfg, "prefill", MODEL_BATCH, PROMPT_LEN, seed=0)
    tally = {"prefill": 0, "decode": 0}
    counted = dataclasses.replace(
        bundle, prefill=_counting(bundle.prefill, tally, "prefill"),
        decode_step=_counting(bundle.decode_step, tally, "decode"))
    for fn in counters.values():
        fn.launches = 0
    out = generate(counted, params, batch, DECODE_STEPS + 1)
    launches = {n: fn.launches for n, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    if tally != {"prefill": cfg.n_layers, "decode": 0} or launches != {
            **{n: 0 for n in counters}, "flash_attention": cfg.n_layers}:
        raise AssertionError(f"model path launches {tally} / {launches}")
    if tuple(out.logits.shape) != (MODEL_BATCH, DECODE_STEPS + 1,
                                   cfg.vocab_size):
        raise AssertionError(f"logits shape {tuple(out.logits.shape)}")
    if not bool(torch.isfinite(out.logits).all()):
        raise AssertionError("non-finite logits on the model path")

    # Layer 0's prefill attention: the kernel route the path took, against
    # the plain chunked scan, which also computes in fp32 and rounds once
    # (ATTN_TOL's bf16 limit).
    layer0 = tree_map(lambda t: t[0], params["stack"]["blocks"][0])
    x = params["embed"][torch.as_tensor(batch["tokens"], device=dev).long()]
    h = apply_norm(layer0["norm1"], x, cfg.norm)
    q, k, v = qkv(layer0["temporal"], h, cfg,
                  torch.arange(PROMPT_LEN, device=dev))
    o_kernel = long_attention(q, k, v, True, None, cfg.attn_chunk)
    o_plain = chunked_attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
    try:
        layer0_err = attn_err(o_kernel, o_plain)
    except AssertionError as e:
        raise AssertionError(f"layer-0 attention, kernel vs chunked: {e}") \
            from None
    del x, h, q, k, v, o_kernel, o_plain
    emit({"phase": "model_path", "arch": MODEL_ARCH, "params":
          param_count(params), "param_dtype": cfg.param_dtype,
          "batch": MODEL_BATCH, "prompt_len": PROMPT_LEN,
          "decode_steps": DECODE_STEPS, "init_s": init_s,
          "prefill_s": out.prefill_s, "decode_s": out.decode_s,
          "decode_tokens_per_s": MODEL_BATCH * DECODE_STEPS / out.decode_s,
          "launches_prefill": tally["prefill"],
          "launches_decode": tally["decode"], "launches": launches,
          "logits_finite": True,
          "layer0_attention_max_abs_err_vs_chunked": layer0_err,
          "max_memory_allocated_gb": peak / 1e9,
          "tokens_head": out.tokens[0, :8].tolist(), "nvidia_smi": smi})
    return launches, bundle, params, batch


def _ranged(fn, name):
    from torch.profiler import record_function

    def wrapped(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def phase_model_profile(bundle, params, batch):
    """Where the serving path's time goes: one ``generate`` (prefill of the
    8192-token prompt, then 8 decode steps) under torch.profiler. The
    prefill is synchronized before the first decode step, so device entries
    split at that step's start: device time per phase, its share of the
    phase's (profiled) wall, and the top device entries by name."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import generate

    ranged = dataclasses.replace(
        bundle, prefill=_ranged(bundle.prefill, "model.prefill"),
        decode_step=_ranged(bundle.decode_step, "model.decode_step"))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = generate(ranged, params, batch, PROFILE_DECODE_STEPS + 1)
    events = prof.events()
    split = min(e.time_range.start for e in events
                if e.name == "model.decode_step")
    phases = {"prefill": {}, "decode": {}}
    for e in events:
        # Device entries only; the ranges' own device-side annotations span
        # their kernels and idle gaps, so they are left out.
        if (not str(e.device_type).endswith("CUDA")
                or e.name in ("model.prefill", "model.decode_step")):
            continue
        ph = phases["prefill" if e.time_range.start < split else "decode"]
        us, n = ph.get(e.name, (0.0, 0))
        ph[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    # The host side of decode: self CPU time by name (the decode range's own
    # self time is the Python between ops), the ops it dispatches directly,
    # and the host's waits on the card.
    host, top_ops = {}, 0
    for e in events:
        if str(e.device_type).endswith("CUDA") or e.time_range.start < split:
            continue
        us, n = host.get(e.name, (0.0, 0))
        host[e.name] = (us + e.self_cpu_time_total, n + 1)
        if e.cpu_parent is not None and e.cpu_parent.name == "model.decode_step":
            top_ops += 1
    host_top = sorted(((us, k, n) for k, (us, n) in host.items()),
                      reverse=True)[:8]
    waits_us = sum(us for k, (us, _) in host.items()
                   if "Synchronize" in k or "Memcpy" in k
                   or k == "aten::_local_scalar_dense")
    walls = {"prefill": out.prefill_s, "decode": out.decode_s}
    for name, entries in phases.items():
        dev_us = sum(us for us, _ in entries.values())
        top = sorted(((us, k, n) for k, (us, n) in entries.items()),
                     reverse=True)[:8]
        row = {"phase": "model_profile", "part": name,
               "steps": 1 if name == "prefill" else PROFILE_DECODE_STEPS,
               "wall_s_profiled": walls[name], "device_ms": 1e-3 * dev_us,
               "device_busy_share": 1e-6 * dev_us / walls[name],
               "top_device": [[k[:60], us / 1e3, n] for us, k, n in top]}
        if name == "decode":
            row.update({
                "host_ops_per_step": top_ops / PROFILE_DECODE_STEPS,
                "host_wait_ms": 1e-3 * waits_us,
                "host_top_self": [[k[:60], us / 1e3, n]
                                  for us, k, n in host_top]})
        emit(row)


def phase_model_parity(dev):
    """The port on the card against the port on the host at reduced
    glm4-9b in fp32, the same weights on both: prompts of 33 (plain
    attention) and 160 tokens (> attn_chunk = 64: the kernel on the card,
    the chunked scan on the host), 8 decode steps; logits within 1e-4 of
    the host's largest, greedy tokens equal."""
    import dataclasses

    from repro_torch.configs import demo_batch, get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    from repro_torch.models.transformer import tree_map

    cfg = dataclasses.replace(get_config(MODEL_ARCH).reduced(),
                              param_dtype="float32")
    host, card = build_model(cfg, device="cpu"), build_model(cfg, device=dev)
    p_host = host.init(torch.Generator().manual_seed(0))
    p_card = tree_map(lambda t: t.to(dev), p_host)
    rels = {}
    for prompt in (33, 160):
        batch = demo_batch(cfg, "prefill", 2, prompt, seed=prompt)
        a = generate(host, p_host, batch, 9)
        b = generate(card, p_card, batch, 9)
        rel = float((b.logits.cpu() - a.logits).abs().max()
                    / a.logits.abs().max())
        if rel > 1e-4 or not torch.equal(a.tokens, b.tokens.cpu()):
            raise AssertionError(
                f"card != host at prompt {prompt}: rel {rel}")
        rels[prompt] = rel
    emit({"phase": "model_parity", "arch": cfg.name + " (reduced, fp32)",
          "prompts": [33, 160], "decode_steps": 8,
          "max_rel_logit_err": rels, "greedy_tokens_equal": True})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.usec_matvec import usec_matvec_cuda
    from repro_torch.kernels.usec_segmented import usec_segmented_cuda

    # ---- 1. card ----
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "card", "device": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": False})

    # ---- 2. build ----
    t0 = time.perf_counter()
    paths = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = []
    for p in paths.values():
        log = p.with_suffix(".log")
        if log.exists():
            ptxas += [ln.strip() for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build_s,
          "libraries": sorted(p.name for p in paths.values()),
          "ptxas": ptxas})

    # ---- 3. kernels vs their plain versions ----
    dev = torch.device("cuda", 0)
    kernels = phase_kernels(dev)

    # ---- 4. main path: Sec. V power iteration ----
    phase_parity()
    counters = {"usec_matvec": usec_matvec_cuda,
                "usec_segmented": usec_segmented_cuda,
                "flash_attention": flash_attention_cuda}
    totals = phase_main_path(counters)
    for n in ("usec_matvec", "usec_segmented"):
        if totals[n] <= 0:
            raise AssertionError(f"{n} never launched on the main path")
    if totals["flash_attention"] != 0:
        raise AssertionError("flash_attention launched on the Sec. V path")
    phase_profile()

    # ---- 5. main path: the model stack's serving path (glm4-9b) ----
    kernels["flash_attention"] = phase_flash(dev)
    model_launches, bundle, params, batch = phase_model_path(
        dev, counters, smi)
    totals["flash_attention"] = model_launches["flash_attention"]
    phase_model_profile(bundle, params, batch)
    del bundle, params, batch
    torch.cuda.empty_cache()
    phase_model_parity(dev)

    print(json.dumps({"kernels": [
        {"name": n, **{k: kernels[n][k] for k in ("route", "source",
                                                   "replaces")},
         "launches": totals[n],
         **{k: kernels[n][k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms",
                                       "ms_source", "dispatch_ms")}}
        for n in counters
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
