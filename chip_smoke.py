#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

It builds the hand-written kernels from src/repro_torch/csrc with nvcc (into
build/kernels/), holds each kernel against its plain PyTorch version on the
card and times it (usec_matvec also at the served widths C = 8, 32, 128
beside torch.matmul; tile_checksum against zlib.crc32 at the boundaries of
its span split, from an unaligned base, over 70,001 tiles and over every
tile of the Sec. V staged buffer, with its grid and its share of its bytes
bound; the flash-attention kernels at the JAX tests' cases,
every head_dim in both dtypes: bf16 on the tensor-core kernel, fp32 on the
FFMA kernel; one full-width glm4-9b layer, one deepseek-moe-16b layer and
one recurrentgemma-2b windowed layer),
then drives the paper's Sec. V experiment through the normal front door,
``ElasticEngine(MatVecPowerIteration, backend="device")``: N = 6 workers,
J = 3, a 6000 x 6000 integer-valued matrix, cyclic and MAN placements at
S in {0, 1}, scripted churn, 8 steps, ``verify="exact"`` at every step, in
both executor modes (per-block ``usec_matvec`` and one ``usec_segmented``
launch a step). Then the model stack's serving path: glm4-9b,
deepseek-moe-16b (64 routed experts, top-6), recurrentgemma-2b (RG-LRU +
local attention) and mamba2-370m (Mamba-2 SSD) in turn at full width and
depth with random weights through ``repro_torch.launch.serve.generate`` (an
8192-token prompt, 32 greedy decode steps; one kernel launch per prefill
attention layer, none in decode; the first attention layer and layer 0's
MoE FFN against their plain versions; the first rglru and ssm layer's
prefill-to-decode state handoff in fp32), a profiled prefill + decode
each, the MoE decode's expert-read floor, and card-vs-host parity at
reduced size (glm4-9b, both MoE models and both recurrent models). Then
``checkpoint`` cuts Sec. V runs after step 5 and resumes them bitwise in
fresh engines (and a card checkpoint on the host), and
``serve_path`` drives serve_cli's seeded request trace through both serving
lanes at Sec. V width (every response exact, launches per window exact,
snapshots equal to the host's at 768^2). Last, ``elastic_faults`` injects
every fault kind into the Sec. V runs (covered at S = 1, uncovered at
S = 0, silent corruption with the integrity checker on, a corruption of the
card's copy alone found by the tile_checksum audit) and holds each to the
clean run bitwise, with the staged buffer repaired in place on the card and
exact launch counts; it runs after every profiled phase, since the
profiler's trace loses kernel records after it. Every phase prints one
JSON line; the
line before the last lists every kernel with its launches on the main path,
its time, its bound and its plain version's time; the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero,
and without a CUDA device it exits non-zero before printing a result.
"""

import gc
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

# The paper's Sec. V setup (src/repro_torch/configs/usec_paper.py).
from repro_torch.configs import usec_paper as PAPER  # noqa: E402

N_WORKERS, REPLICATION, DIM = (PAPER.N_MACHINES, PAPER.REPLICATION,
                               PAPER.MATRIX_DIM)
BLOCK_ROWS, STEPS = PAPER.BLOCK_ROWS, 8
BASE_SPEEDS = list(PAPER.BASE_SPEEDS)
# Served windows' widths (ServeConfig.batch_cols) the block kernel is
# timed at, beside the main path's C = 1.
WIDE_COLS = (8, 32, 128)
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


def device_ms(fn, iters: int, tag: str = "", tries: int = 3):
    """Mean device ms per call of ``fn``, over the device entries whose
    name contains ``tag`` (all of them by default), from the first of
    ``tries`` traces that kept every record; None when none did. A trace
    lost records when it shows no entry, or an entry counted a number of
    times that is not a multiple of ``iters`` (each call launches the same
    work)."""
    for _ in range(tries):
        hits = [v for k, v in device_times(fn, iters).items() if tag in k]
        if hits and not any(n % iters for _, n in hits):
            return 1e-3 * sum(h[0] for h in hits) / iters
    return None


def rel_err(got, want) -> float:
    scale = float(want.abs().max()) or 1.0
    return float((got.float() - want.float()).abs().max()) / scale


def reset_launches(counters) -> None:
    """Set every kernel's launch count to 0 (the flash wrapper's per-route
    counts too)."""
    for fn in counters.values():
        fn.launches = 0
        for route in ("launches_tc", "launches_ffma"):
            if hasattr(fn, route):
                setattr(fn, route, 0)


def ptxas_report(lib_path):
    """Registers, spill bytes and static shared memory per kernel from
    nvcc's ``-Xptxas -v`` log beside a built library: [{"kernel",
    "registers", "spill_stores", "spill_loads", "smem"}], kernels named
    ``<name><template args>``."""
    import re

    rows, cur = [], None
    for ln in lib_path.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            n = re.search(r"\d([a-z][a-z_]*_kernel)I(\w*?)L[ib](\d+)E",
                          m.group(1))
            cur = {"kernel": (f"{n.group(1)}<{n.group(2) or ''}"
                              f"{',' if n.group(2) else ''}{n.group(3)}>"
                              if n else m.group(1)[:60])}
            rows.append(cur)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", ln)
        if m and cur is not None:
            cur["smem"] = int(m.group(1))
    return rows


def grid_operands(rng, shape_x, k, c, dev):
    """Integer X and a 2^-4 grid W: every partial sum is exact in fp32."""
    x = torch.as_tensor(rng.integers(-3, 4, size=shape_x).astype(np.float32),
                        device=dev)
    w = torch.as_tensor((rng.integers(-8, 9, size=(k, c)) / 16.0)
                        .astype(np.float32), device=dev)
    return x, w


def timed(fn, iters: int, tag: str = "", bound: float = 0.0):
    """A call's time: device time from the profiler's trace (``ms``), and
    the CUDA-event time of back-to-back calls, which includes the host's
    dispatch (``dispatch_ms``). Where the trace shows no device entry,
    lost records, or less time than the work's ``bound`` (ms), the event
    time stands in, and ``ms_source`` says so (``trace_ms`` keeps what the
    trace said)."""
    dispatch = cuda_ms(fn, iters)
    dev = device_ms(fn, iters, tag)
    if dev is None or dev < bound:
        return {"ms": dispatch, "ms_source": "cuda_events", "trace_ms": dev,
                "dispatch_ms": dispatch}
    return {"ms": dev, "ms_source": "profiler", "dispatch_ms": dispatch}


def phase_kernels(dev):
    from repro_torch.core import USECScheduler, make_placement
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import matvec_ref
    from repro_torch.kernels.usec_matvec import CLUSTER, usec_matvec_cuda
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
    mv_bound, mv_by = bound_ms(
        BLOCK_ROWS * DIM * 4 + DIM * 4 + BLOCK_ROWS * 4,
        2 * BLOCK_ROWS * DIM)
    mv = timed(lambda: usec_matvec_cuda(
        blocks[next(it) % len(blocks)], w1, out=out), 900, "matvec_kernel",
        mv_bound)
    mv_plain = timed(lambda: matvec_ref(
        blocks[next(it) % len(blocks)], w1), 900, bound=mv_bound)
    mv_lib = timed(lambda: torch.matmul(
        blocks[next(it) % len(blocks)], w1), 900, bound=mv_bound)
    # Served windows run the block kernel at C = batch_cols columns: the
    # same blocks at C in {8, 32, 128}, bitwise on the integer grid, timed
    # beside torch.matmul (TF32 off).
    wide = []
    for c in WIDE_COLS:
        xg, wg = grid_operands(rng, (BLOCK_ROWS, DIM), DIM, c, dev)
        if not torch.equal(usec_matvec_cuda(xg, wg), torch.matmul(xg, wg)):
            raise AssertionError(f"usec_matvec != torch.matmul at C={c}")
        wc = torch.randn((DIM, c), device=dev)
        oc = torch.empty((BLOCK_ROWS, c), device=dev)
        b_c, by_c = bound_ms(
            BLOCK_ROWS * DIM * 4 + DIM * c * 4 + BLOCK_ROWS * c * 4,
            2 * BLOCK_ROWS * DIM * c)
        wide.append({
            "C": c, "bound_us": 1e3 * b_c, "bound_by": by_c,
            "kernel": timed(lambda: usec_matvec_cuda(
                blocks[next(it) % len(blocks)], wc, out=oc), 600,
                "matvec_kernel", b_c),
            "plain": timed(lambda: matvec_ref(
                blocks[next(it) % len(blocks)], wc), 600, bound=b_c),
            "library": timed(lambda: torch.matmul(
                blocks[next(it) % len(blocks)], wc), 600, bound=b_c)})
    del big, blocks
    emit({"phase": "kernel", "name": "usec_matvec", "wide": wide,
          "cases": len(rows), "bitwise_integer_grid": True,
          "max_rel_err_fp32": max(r[3] for r in rows),
          "max_rel_err_bf16": max(r[4] for r in rows),
          "shape": [BLOCK_ROWS, DIM, 1], "kernel": mv, "plain": mv_plain,
          "library": mv_lib, "bound_us": 1e3 * mv_bound,
          "cluster_ctas_per_row": CLUSTER,
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
    real_rows = int(bp.n_blocks.sum()) * BLOCK_ROWS
    sg_bound, sg_by = bound_ms(
        real_rows * DIM * 4 + DIM * 4 + out4.numel() * 4
        + N_WORKERS * b_max * 12 + N_WORKERS * 4,
        2 * real_rows * DIM)
    sg = timed(lambda: usec_segmented_cuda(*args, out=out4), 50,
               "segmented_kernel", sg_bound)
    sg_plain = timed(lambda: segmented_plain(*args), 20, bound=sg_bound)
    emit({"phase": "kernel", "name": "usec_segmented",
          "bitwise_integer_grid": True, "cases_c": [1, 3, 128],
          "max_rel_err_fp32": max(seg_errs), "real_rows": real_rows,
          "shape": [N_WORKERS, b_max, BLOCK_ROWS, DIM, 1],
          "kernel": sg, "plain": sg_plain, "library": None,
          "bound_us": 1e3 * sg_bound,
          "launches": usec_segmented_cuda.launches})
    del seg_cases, args, out4
    tc = tile_checksum_phase(dev, staged, sm)
    del staged
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
        "tile_checksum": tc,
    }


def tile_checksum_phase(dev, staged, sm):
    """The tile audit's kernel: against its plain version (run with the
    kernel's split of spans over warps) and zlib.crc32 on small buffers
    (random, all-zero and all-ones bytes; 16-byte and odd tile byte counts
    on every boundary of the 512-byte span split; a buffer one byte past
    its allocation, the byte path; 70,001 tiles in one launch), then against
    zlib.crc32 of every tile of the Sec. V staged buffer (432 MB, one
    launch), timed against its bytes bound, with its grid, GB/s and share
    of the bound. The kernel is an integer checksum: equality is the
    limit. No PyTorch call computes a CRC32, so it has no library time."""
    import zlib

    from repro_torch.kernels.tile_checksum import (
        SPAN,
        WARPS,
        tile_checksum_cuda,
        tile_checksum_grid,
        tile_checksum_plain,
    )

    def check(xd, what):
        got = tile_checksum_cuda(xd, 1)
        plain = tile_checksum_plain(
            xd, 1, n_warps=tile_checksum_grid(xd, 1)["warps"])
        want = [zlib.crc32(r.tobytes()) for r in xd.cpu().numpy()]
        if not torch.equal(got, plain) or got.cpu().tolist() != want:
            raise AssertionError(f"tile_checksum disagrees: {what}")

    rng = np.random.default_rng(5)
    small = 0
    for n_bytes in (1, 3, 16, SPAN - 1, SPAN, SPAN + 1, SPAN + 16,
                    4096, 37 * SPAN + 1, SPAN * WARPS + 16, 131_088,
                    393_217):
        for fill in ("random", "zeros", "ones"):
            x = (rng.integers(0, 256, size=(3, n_bytes), dtype=np.uint8)
                 if fill == "random" else
                 np.full((3, n_bytes), 0 if fill == "zeros" else 255,
                         np.uint8))
            check(torch.from_numpy(x).to(dev), f"{n_bytes} bytes ({fill})")
            small += 1
    buf = torch.as_tensor(rng.integers(0, 256, size=3 * 4099 + 1,
                                       dtype=np.uint8), device=dev)
    shifted = buf[1:].view(3, 4099)
    assert shifted.data_ptr() % 16 == 1
    check(shifted, "a base one byte past its allocation")
    many = torch.as_tensor(rng.integers(0, 256, size=(70_001, 16),
                                        dtype=np.uint8), device=dev)
    check(many, "70,001 tiles")
    small += 2
    t0 = time.perf_counter()
    want = np.array([[zlib.crc32(sm.staged[n, t].tobytes())
                      for t in range(sm.staged.shape[1])]
                     for n in range(sm.staged.shape[0])], dtype=np.int64)
    zlib_s = time.perf_counter() - t0
    grid = tile_checksum_grid(staged, 2)
    got = tile_checksum_cuda(staged, 2).cpu().numpy()
    plain = tile_checksum_plain(staged, 2, n_warps=grid["warps"])
    if not (np.array_equal(got, want)
            and np.array_equal(plain.cpu().numpy(), want)):
        raise AssertionError("tile_checksum != zlib.crc32 on the Sec. V "
                             "staged buffer")
    n_bytes = staged.numel() * staged.element_size()
    tc_bound, tc_by = bound_ms(n_bytes + got.size * 8, 0.0)
    tc = timed(lambda: tile_checksum_cuda(staged, 2), 30, "tile_crc",
               tc_bound)
    tc_plain = timed(lambda: tile_checksum_plain(
        staged, 2, n_warps=grid["warps"]), 2, bound=tc_bound)
    emit({"phase": "kernel", "name": "tile_checksum", "small_cases": small,
          "equals_zlib": True, "tiles": int(got.size),
          "staged_mb": n_bytes / 1e6, "grid": grid, "kernel": tc,
          "plain": tc_plain, "library": None, "bound_us": 1e3 * tc_bound,
          "gb_per_s": n_bytes / tc["ms"] / 1e6,
          "bound_share": tc_bound / tc["ms"],
          "host_zlib_s": zlib_s, "launches": tile_checksum_cuda.launches})
    return {"route": "cuda", "source": "src/repro_torch/csrc/tile_checksum.cu",
            "replaces": "src/repro/faults/integrity.py:71 (host zlib; no "
                        "TPU kernel)",
            "max_abs_err": 0.0, **tc, "plain_ms": tc_plain["ms"],
            "bound_ms": tc_bound, "bound_by": tc_by, "library_ms": None}


def power_iteration(dev, x, kind, replication, s_tol, segmented, n_workers,
                    speeds, script, steps, block_rows, profiler=None,
                    arrival="barrier", fuse_steps=1, replan="central",
                    kill=None, inject=True, on_runner=None, on_warm=None,
                    faults=None, cfg=None):
    """One Sec. V engine run. ``inject`` forces one straggler per step at
    S > 0 (first-arrival derives its own sets when it is False);
    ``on_runner(runner)`` sees the runner before the run. With ``on_warm``
    the engine runs once unprofiled first (capturing the window graph), then
    ``on_warm(runner)`` sees it, so a profile covers a steady run.
    ``faults`` goes to ``run(faults=)`` and ``cfg`` updates the
    EngineConfig (e.g. ``verify_results``, ``dispatch_timeout``). Returns
    the (last) run's EngineResult; its ``result`` is the power iteration's."""
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

    ecfg = dict(block_rows=block_rows, verify="exact", segmented=segmented,
                arrival=arrival, fuse_steps=fuse_steps, replan=replan)
    ecfg.update(cfg or {})
    engine = ElasticEngine(
        MatVecPowerIteration(seed=0),
        Policy(placement=kind, replication=replication, stragglers=s_tol),
        EngineConfig(**ecfg),
        backend="device", n_machines=n_workers,
        clock=SyntheticSpeedClock(speeds, jitter_sigma=0.03, seed=0),
        device=dev,
    )
    # Stage X first: a profile covers steps only, and on_runner can wrap.
    engine._runner = engine._build_runner(x)
    if on_runner is not None:
        on_runner(engine._runner)

    def run():
        return engine.run(
            None, n_steps=steps, events=scripted_trace(n_workers, script),
            straggler_sets=one_straggler if s_tol and inject else None,
            kill_scheduler_at=kill, faults=faults)

    if on_warm is not None:
        run()
        on_warm(engine._runner)
    if profiler is not None:
        profiler.start()
    try:
        return run()
    finally:
        if profiler is not None:
            torch.cuda.synchronize()
            profiler.stop()


PARITY_MODES = {"barrier": {}, "first": {"arrival": "first", "inject": False},
                "fused4": {"fuse_steps": 4},
                "fused4_first": {"fuse_steps": 4, "arrival": "first",
                                 "inject": False}}


def phase_parity():
    """The port on the card against the port on the host (the plain
    versions, themselves held against the JAX package by the CPU tests) at
    the CPU tests' size: bitwise eigvec, residuals and realized straggler
    sets, for the barrier, first-arrival, fused windows of 4 and fused
    first-arrival."""
    from repro_torch.runtime import make_exact_matrix

    x = make_exact_matrix(768, 0)
    script4 = {0: ((3,), ()), 1: ((1,), (3,)), 2: ((), (1,)),
               4: ((2,), ()), 5: ((), (2,))}
    for mode, kw in PARITY_MODES.items():
        for seg in (None, "auto"):
            res = {}
            for dev in ("cpu", "cuda"):
                res[dev] = power_iteration(
                    dev, x, "man", 3, 1, seg, 4,
                    [1000.0, 1300.0, 1700.0, 2200.0], script4, 6, 16,
                    **kw).result
            a, b = res["cpu"], res["cuda"]
            same = (np.array_equal(a.eigvec, b.eigvec)
                    and a.residuals == b.residuals
                    and [r.straggled for r in a.reports]
                    == [r.straggled for r in b.reports])
            if not same:
                raise AssertionError(
                    f"card != host at {mode}, segmented={seg}")
    emit({"phase": "parity", "size": [4, 768], "bitwise_card_vs_host": True,
          "modes": list(PARITY_MODES), "segmented": [None, "auto"]})


def phase_main_path(counters):
    from repro_torch.runtime import make_exact_matrix

    x = make_exact_matrix(DIM, 0)
    totals = {name: 0 for name in counters}
    mains = {}
    for kind in ("cyclic", "man"):
        for s_tol in (0, 1):
            outs = {}
            for seg in (None, "auto"):
                reset_launches(counters)
                t0 = time.perf_counter()
                res = power_iteration(None, x, kind, REPLICATION, s_tol, seg,
                                      N_WORKERS, BASE_SPEEDS, SCRIPT, STEPS,
                                      BLOCK_ROWS).result
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
                outs[seg] = mains[(kind, s_tol, seg)] = res
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
    return totals, mains


class _CountingWindow:
    """The runner's fused driver, counting the real blocks of the active
    steps it is given (the per-block mode's launches) and its calls."""

    def __init__(self, inner):
        self.inner, self.blocks, self.calls = inner, 0, 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self, staged, plans, bad, active, w):
        self.calls += 1
        self.blocks += sum(sum(len(b) for b in p.blocks)
                           for p, a in zip(plans, active.tolist()) if a)
        return self.inner(staged, plans, bad, active, w)


def _expectations(runner, tally):
    """Wrap a runner's drivers so a run tallies what its launch counts must
    be: per barrier executor call its real blocks (``step_*``; counted
    around ``_barrier_dispatch``, outside the wall it times), per worker
    dispatch (first-arrival) its real blocks, per window the real blocks of
    its active steps; and, from each step's adopted plan, the real blocks
    and loaded workers the plan says."""
    tally.update(step_calls=0, step_blocks=0)
    inner_step = runner._barrier_dispatch

    def stepwise(entry, w, bad):
        tally["step_calls"] += 1
        tally["step_blocks"] += sum(len(b) for b in entry.dev.blocks)
        return inner_step(entry, w, bad)

    runner._barrier_dispatch = stepwise
    if runner._worker_exec is not None:
        inner = runner._worker_exec

        def worker(staged, widx, plan, w, include):
            tally["worker_calls"] += 1
            tally["worker_blocks"] += len(plan.blocks[widx])
            return inner(staged, widx, plan, w, include)

        runner._worker_exec = worker
        step = runner.step

        def observed(*a, **k):
            out = step(*a, **k)
            nb = runner._current.block.n_blocks
            tally["plan_blocks"] += int(nb.sum())
            tally["plan_loaded"] += int((nb > 0).sum())
            return out

        runner.step = observed
    if runner._fused is not None:
        runner._fused = tally["window"] = _CountingWindow(runner._fused)


def graph_capture_probe(dev):
    """usec_matvec launches as a cluster through cudaLaunchKernelEx: capture
    one launch in a CUDA graph, replay it, and hold it to the eager launch
    bitwise (the per-block window graph of a later change needs this)."""
    from repro_torch.kernels.usec_matvec import usec_matvec_cuda

    rng = np.random.default_rng(3)
    x, w = grid_operands(rng, (BLOCK_ROWS, DIM), DIM, 1, dev)
    want = usec_matvec_cuda(x, w)
    out = torch.zeros_like(want)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        usec_matvec_cuda(x, w, out=out)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        usec_matvec_cuda(x, w, out=out)
    out.zero_()
    g.replay()
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        raise AssertionError("captured usec_matvec differs from eager")
    return True


def fused_update_probe(dev):
    """The power iteration's on-card update against the host quantize_unit,
    bitwise, on Sec. V-sized vectors (the card's sqrt and division must be
    IEEE round-to-nearest, as the host's)."""
    from repro_torch.api import MatVecPowerIteration
    from repro_torch.runtime import make_exact_matrix, quantize_unit

    upd = MatVecPowerIteration().fused_update()
    rng = np.random.default_rng(4)
    x = make_exact_matrix(DIM, 0)
    vs = [rng.normal(size=DIM).astype(np.float32) * s
          for s in (1.0, 1e3, 1e-3)]
    w = quantize_unit(rng.normal(size=DIM))
    vs.append(x @ w)
    flat = np.ones(400_000, dtype=np.float32)
    flat[12_345] = 1.1              # all-zero quantization: the fallback
    vs.append(flat)
    for v in vs:
        got = upd(torch.as_tensor(v, device=dev), None).cpu().numpy()
        if got.tobytes() != quantize_unit(v).tobytes():
            raise AssertionError("fused_update on the card != quantize_unit")
    return len(vs)


ELASTIC_VARIANTS = {
    "first": {"arrival": "first", "inject": False},
    "fused4": {"fuse_steps": 4},
    "fused4_first": {"fuse_steps": 4, "arrival": "first", "inject": False},
    "kill2_decentral": {"replan": "decentral", "kill": 2},
}


def _same(a, b, sets: bool = True) -> bool:
    """Bitwise eigvec and residuals, and (``sets``) the same straggler
    sets. Derived first-arrival sets follow the plans, and a fused run's
    plans may differ from stepwise (the EWMA is fed once a window), so
    fused first-arrival is held to the outputs only."""
    return (np.array_equal(a.eigvec, b.eigvec) and a.residuals == b.residuals
            and (not sets or [r.straggled for r in a.reports]
                 == [r.straggled for r in b.reports]))


def check_launches(cell, seg, arrival, fuse, tally, launches, repaired=0):
    """The run's kernel launches are exactly what its dispatches say: per
    real block of every barrier executor call, worker dispatch or active
    window step (per-block); one per barrier executor call or worker
    dispatch, or 2 x K at the window graph's capture with one replay a
    window (segmented); plus one ``usec_matvec`` per row chunk a fused
    window recomputed from a replica tile (``repaired``)."""
    win = tally.get("window")
    if fuse > 1:
        want = (win.blocks if seg is None else 0,
                0 if seg is None else 2 * fuse)
        if seg is not None and win.replays != win.calls:
            raise AssertionError(f"{cell}: {win.replays} replays for "
                                 f"{win.calls} windows")
    elif arrival == "first":
        want = (tally["worker_blocks"] if seg is None else 0,
                0 if seg is None else tally["worker_calls"])
    else:
        want = (tally["step_blocks"] if seg is None else 0,
                0 if seg is None else tally["step_calls"])
    want = (want[0] + repaired, want[1])
    got = (launches["usec_matvec"], launches["usec_segmented"])
    if got != want or launches["flash_attention"] != 0:
        raise AssertionError(f"{cell}: launches {launches}, want {want}")


def phase_elastic_modes(counters, mains, smi):
    """The engine's other ways to run a step, at the main path's Sec. V
    configuration (N = 6, J = 3, 6000^2, 8 steps of the same churn), for
    cyclic and MAN x S in {0, 1} x both executor modes: first-arrival
    (stepwise), fused windows of 4 (barrier, the main path's forced
    stragglers) and fused first-arrival, plus the scheduler kill before
    step 2 under replan="decentral". verify="exact" at every step of every
    run. Checks: executor_cache_size == 1; first-arrival at S = 0 equals the
    barrier run; each fused run equals its stepwise twin (same arrival);
    the kill run equals the run without it; exact launch counts (per-block
    first-arrival: the loaded workers' real blocks; segmented
    first-arrival: one per loaded worker a step; fused per-block: the
    active steps' real blocks; fused segmented: one graph replay a window
    and usec_segmented launched only at capture: K warm-up + K captured).
    Returns the launches of these runs."""
    from repro_torch.runtime import make_exact_matrix

    dev = torch.device("cuda", 0)
    probes = {"usec_matvec_graph_capture": graph_capture_probe(dev),
              "fused_update_bitwise_vectors": fused_update_probe(dev)}
    x = make_exact_matrix(DIM, 0)
    totals = {name: 0 for name in counters}
    firsts = {}
    for kind in ("cyclic", "man"):
        for s_tol in (0, 1):
            for seg in (None, "auto"):
                for variant, kw in ELASTIC_VARIANTS.items():
                    tally = {"worker_calls": 0, "worker_blocks": 0,
                             "plan_blocks": 0, "plan_loaded": 0}
                    reset_launches(counters)
                    t0 = time.perf_counter()
                    res = power_iteration(
                        None, x, kind, REPLICATION, s_tol, seg, N_WORKERS,
                        BASE_SPEEDS, SCRIPT, STEPS, BLOCK_ROWS,
                        on_runner=lambda r: _expectations(r, tally),
                        **kw).result
                    seconds = time.perf_counter() - t0
                    launches = {n: fn.launches for n, fn in counters.items()}
                    for n, v in launches.items():
                        totals[n] += v
                    cell = f"{kind} S={s_tol} segmented={seg} {variant}"
                    if res.executor_cache_size != 1:
                        raise AssertionError(
                            f"{cell}: executor_cache_size "
                            f"{res.executor_cache_size}")
                    if not (np.all(np.isfinite(res.eigvec))
                            and res.eigvec.shape == (DIM,)
                            and len(res.reports) == STEPS):
                        raise AssertionError(f"{cell}: bad result shape")
                    fuse = kw.get("fuse_steps", 1)
                    arrival = kw.get("arrival", "barrier")
                    first = arrival == "first"
                    want = mains[(kind, s_tol, seg)]
                    win = tally.get("window")
                    replays = win.replays if win is not None else 0
                    check_launches(cell, seg, arrival, fuse, tally, launches)
                    if first and fuse == 1:
                        firsts[(kind, s_tol, seg)] = res
                        if (tally["worker_blocks"] != tally["plan_blocks"]
                                or tally["worker_calls"]
                                != tally["plan_loaded"]):
                            raise AssertionError(f"{cell}: dispatch {tally}")
                        if s_tol == 0 and not _same(res, want):
                            raise AssertionError(
                                f"{cell}: first-arrival != barrier at S=0")
                    elif fuse > 1:
                        twin = (firsts[(kind, s_tol, seg)] if first
                                else want)
                        if not _same(res, twin, sets=not first):
                            raise AssertionError(
                                f"{cell}: fused != stepwise twin")
                    elif not _same(res, want):
                        raise AssertionError(
                            f"{cell}: kill run != run without the kill")
                    walls = [r.wall_s for r in res.reports]
                    emit({"phase": "elastic_modes", "placement": kind,
                          "S": s_tol, "segmented": seg, "variant": variant,
                          "steps": len(res.reports), "verify": "exact",
                          "steps_per_s": res.steps_per_sec,
                          "step_wall_ms": [1e3 * t for t in walls],
                          "straggled": [list(r.straggled)
                                        for r in res.reports],
                          "executor_cache_size": res.executor_cache_size,
                          "launches": launches,
                          "dispatches": (win.calls if win is not None
                                         else tally["worker_calls"] or None),
                          "graph_replays": replays,
                          "run_s": seconds, "nvidia_smi": smi})
    emit({"phase": "elastic_modes_checks", **probes,
          "first_s0_equals_barrier": True, "fused_equals_stepwise": True,
          "kill_equals_no_kill": True, "launch_counts_exact": True,
          "nvidia_smi": smi})
    return totals


# ---------------------------------------------------------------------- #
# The serving path at Sec. V
# ---------------------------------------------------------------------- #
SERVE_REQUESTS = 48
# (segmented, batch_cols, corruption_rate, seed). The corrupted cell's
# seed gives a fault schedule whose corruptions land on rows their steps
# deliver (seed 0's fall on a worker that delivers none, or past the trace).
SERVE_CELLS = ((None, 8, 0.0, 0), ("auto", 8, 0.0, 0), (None, 32, 0.0, 0),
               ("auto", 32, 0.0, 0), ("auto", 8, 0.1, 3))


def _serve_args(seg, batch_cols, corruption, seed, dim=None, device=None):
    """serve_cli's arguments for one cell: the paper's fleet
    (configs/usec_paper.py), 48 requests, every 3rd a mapreduce query,
    worker 1 preempted before request 8 and back 4 requests later."""
    from repro_torch.launch import serve_cli

    argv = ["--paper", "--requests", str(SERVE_REQUESTS),
            "--mapreduce-every", "3", "--churn-at", "8",
            "--batch-cols", str(batch_cols),
            "--corruption-rate", str(corruption), "--seed", str(seed)]
    if seg is not None:
        argv += ["--segmented", seg]
    if dim is not None:
        argv += ["--dim", str(dim), "--block-rows", "16"]
    if device is not None:
        argv += ["--device", device]
    return serve_cli.parse_args(argv)


def _watch_lanes(server, tally):
    """Per linear window: the block kernels' launches and the plan's real
    blocks; per lane: the host wall of every submit (it ends in the
    result's copy to the host, so it is synchronized)."""
    from repro_torch.kernels.usec_matvec import usec_matvec_cuda
    from repro_torch.kernels.usec_segmented import usec_segmented_cuda

    runner = server._lanes["linear"].runner
    dispatch = runner._barrier_dispatch

    def counted(entry, w, bad):
        before = (usec_matvec_cuda.launches, usec_segmented_cuda.launches)
        out = dispatch(entry, w, bad)
        tally["linear"].append((
            usec_matvec_cuda.launches - before[0],
            usec_segmented_cuda.launches - before[1],
            sum(len(b) for b in entry.dev.blocks)))
        return out

    runner._barrier_dispatch = counted
    for name, eng in server._lanes.items():
        def timed(operand, event=None, stragglers=None, _sub=eng.submit,
                  _name=name):
            t0 = time.perf_counter()
            out = _sub(operand, event=event, stragglers=stragglers)
            tally["walls"].setdefault(_name, []).append(
                time.perf_counter() - t0)
            return out

        eng.submit = timed


def _device_busy_ms(prof) -> float:
    """Device time in a CUDA-only profile (kernels and copies), ms."""
    return 1e-3 * sum(
        getattr(ev, "self_device_time_total", 0) or 0
        for ev in prof.key_averages()
        if str(ev.device_type).endswith("CUDA"))


def phase_serve_path(counters, smi):
    """The serving path at full Sec. V width, through serve_cli's server
    and seeded trace: make_exact_matrix(6000), cyclic, N = 6, J = 3,
    S = 1, block_rows 20, the paper's speeds, both lanes (the MatMat lane
    and the mapreduce lane) staged on the card. 48 requests (every 3rd a
    mapreduce query, worker 1 preempted before request 8 and back 4
    later) at batch_cols 8 and 32 in the per-block and segmented modes,
    and one run with --corruption-rate 0.1 (the server's Freivalds window
    audit requeues the corrupted windows). Checks: every ok linear
    response is bitwise X(float64) @ operand (every partial sum is an
    integer below 2^24), every mapreduce response the exact float64 sum
    of squares; the linear lane launches the plan's real blocks a window
    (per-block) or one usec_segmented (segmented), the mapreduce lane no
    kernel of the port; each cell's snapshot (counters and synthetic
    latencies) equals the port's device="cpu" run of the same trace at
    768^2. Prints the host wall per window and, for the batch_cols 8
    runs, the device's busy share (device time in a CUDA-only profile of
    the whole trace over its wall). Returns the launches of these
    runs."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve_cli

    t_phase = time.perf_counter()
    totals = {name: 0 for name in counters}
    for seg, cols, corruption, seed in SERVE_CELLS:
        gc.collect()
        torch.cuda.empty_cache()
        args = _serve_args(seg, cols, corruption, seed)
        t0 = time.perf_counter()
        server, x = serve_cli.build_server(args)
        build_s = time.perf_counter() - t0
        x64 = x.astype(np.float64)
        sumsq = float(np.sum(x64 ** 2))
        tally = {"linear": [], "walls": {}}
        _watch_lanes(server, tally)
        record = {}
        reset_launches(counters)
        prof = None
        if cols == 8 and corruption == 0.0:
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
        t0 = time.perf_counter()
        try:
            resps = serve_cli.run_trace(server, args, record)
            torch.cuda.synchronize()
            trace_s = time.perf_counter() - t0
        finally:
            t1 = time.perf_counter()
            if prof is not None:
                prof.stop()
            stop_s = time.perf_counter() - t1
        launches = {n: fn.launches for n, fn in counters.items()}
        for n, v in launches.items():
            totals[n] += v
        snap = serve_cli.snapshot(server, resps)
        cell = f"serve_path segmented={seg} batch_cols={cols} " \
               f"corruption={corruption} seed={seed}"
        # Exactness: the linear answers in one float64 product.
        ok = [r for r in resps if r.status == "ok"]
        lin = [r for r in ok if r.kind != "mapreduce"]
        ops_ = [np.asarray(record[r.rid][1], np.float64).reshape(
            x.shape[1], -1) for r in lin]
        want = x64 @ np.concatenate(ops_, axis=1)
        got = np.concatenate([np.asarray(r.result, np.float64).reshape(
            x.shape[0], -1) for r in lin], axis=1)
        mr = [r.result for r in ok if r.kind == "mapreduce"]
        if len(ok) != SERVE_REQUESTS or not np.array_equal(got, want) \
                or any(v != sumsq for v in mr) or not mr:
            raise AssertionError(
                f"{cell}: {len(ok)} ok of {SERVE_REQUESTS}, linear exact "
                f"{np.array_equal(got, want)}, mapreduce {mr[:3]}")
        per = [(m, g) for m, g, _ in tally["linear"]]
        want_per = [(b, 0) if seg is None else (0, 1)
                    for _, _, b in tally["linear"]]
        if per != want_per or launches["usec_matvec"] != sum(
                p[0] for p in per) or launches["usec_segmented"] != sum(
                p[1] for p in per) or launches["flash_attention"] \
                or launches["tile_checksum"]:
            raise AssertionError(f"{cell}: launches {launches}, per window "
                                 f"{per[:4]} want {want_per[:4]}")
        if corruption and not (snap["integrity"]["failures"]
                               and snap["integrity"]["requeued"]):
            raise AssertionError(f"{cell}: no corrupted window was "
                                 f"requeued: {snap['integrity']}")
        for lane in snap["lanes"].values():
            if lane["jit_cache_size"] != 1:
                raise AssertionError(f"{cell}: {snap['lanes']}")
        walls = tally["walls"]
        busy = None
        t0 = time.perf_counter()
        if prof is not None:
            busy = _device_busy_ms(prof) / (1e3 * trace_s)
        check_s = time.perf_counter() - t0 + stop_s
        emit({"phase": "serve_path", "segmented": seg, "batch_cols": cols,
              "corruption_rate": corruption, "requests": SERVE_REQUESTS,
              "responses_ok": len(ok), "mapreduce_responses": len(mr),
              "linear_windows": len(tally["linear"]),
              "mapreduce_windows": len(walls.get("mapreduce", [])),
              "blocks_per_linear_window": float(np.mean(
                  [b for _, _, b in tally["linear"]])),
              "host_wall_ms_per_window": {
                  k: 1e3 * float(np.mean(v)) for k, v in walls.items()},
              "host_wall_ms_median": {
                  k: 1e3 * float(np.median(v)) for k, v in walls.items()},
              "device_busy_share_profiled": busy,
              "trace_s": trace_s, "server_build_s": build_s,
              "profile_read_s": check_s,
              "latency": snap["latency"], "integrity": snap["integrity"],
              "windows": snap["windows"], "launches": launches,
              "nvidia_smi": smi})
        del server, resps, ok, lin, got, want, tally, prof, x64
    # Card against host: the same traces at 768^2 (block_rows 16).
    t_host = time.perf_counter()
    for seg, cols, corruption, seed in SERVE_CELLS:
        snaps = {}
        for dev in ("cuda", "cpu"):
            args = _serve_args(seg, cols, corruption, seed, dim=768,
                               device=dev)
            server, _ = serve_cli.build_server(args)
            snaps[dev] = json.loads(json.dumps(serve_cli.snapshot(
                server, serve_cli.run_trace(server, args))))
            del server
        if snaps["cuda"] != snaps["cpu"]:
            raise AssertionError(
                f"serve_path 768^2 segmented={seg} batch_cols={cols} "
                f"corruption={corruption}: card snapshot != host snapshot")
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "serve_path_checks", "cells": len(SERVE_CELLS),
          "responses_exact": True, "launches_per_window_exact": True,
          "snapshot_card_equals_host_768": True,
          "host_parity_s": time.perf_counter() - t_host,
          "phase_s": time.perf_counter() - t_phase, "nvidia_smi": smi})
    return totals


# ---------------------------------------------------------------------- #
# Checkpoint / resume at Sec. V
# ---------------------------------------------------------------------- #
CKPT_CUT = 5   # the interrupted run stops after this many steps


def _ckpt_engine(dev, kind, n_workers, speeds, block_rows, seg, fuse,
                 ckpt_dir=None):
    """A power-iteration engine for the checkpoint drills (S = 1, exact
    verify, a jittered synthetic clock, so the EWMA, the plan cache and
    the clock's RNG all carry state across the cut); with ``ckpt_dir`` it
    snapshots every 2 steps."""
    from repro_torch.api import (
        ElasticEngine,
        EngineConfig,
        MatVecPowerIteration,
        Policy,
    )
    from repro_torch.runtime import SyntheticSpeedClock

    return ElasticEngine(
        MatVecPowerIteration(seed=0),
        Policy(placement=kind, replication=REPLICATION, stragglers=1),
        EngineConfig(block_rows=block_rows, verify="exact", segmented=seg,
                     fuse_steps=fuse, checkpoint_dir=ckpt_dir,
                     checkpoint_every=2 if ckpt_dir else None),
        backend="device", n_machines=n_workers,
        clock=SyntheticSpeedClock(speeds, jitter_sigma=0.03, seed=0),
        device=dev)


def _ckpt_drill(x, kind, n_workers, speeds, block_rows, script, seg, fuse,
                root, cut_dev, tail_dev):
    """The restart drill: run CKPT_CUT steps on ``cut_dev`` with a snapshot
    every 2 steps, resume the LATEST one in a fresh engine on
    ``tail_dev``, run to STEPS. Returns (uninterrupted run on
    ``tail_dev``, resumed tail, resumed step, seconds of resume)."""
    import itertools

    from repro_torch.core.elastic import scripted_trace

    evs = list(itertools.islice(scripted_trace(n_workers, script), STEPS))
    args = (kind, n_workers, speeds, block_rows, seg, fuse)
    full = _ckpt_engine(tail_dev, *args).run(x, n_steps=STEPS, events=evs)
    cut = _ckpt_engine(cut_dev, *args, ckpt_dir=root).run(
        x, n_steps=CKPT_CUT, events=evs[:CKPT_CUT])
    if len(cut.checkpoints) != CKPT_CUT // 2:
        raise AssertionError(f"checkpoints {cut.checkpoints}")
    del cut
    gc.collect()
    eng = _ckpt_engine(tail_dev, *args)
    t0 = time.perf_counter()
    step, w = eng.resume(root, data=x)
    resume_s = time.perf_counter() - t0
    tail = eng.run(n_steps=STEPS - step, events=evs[step:], operand=w)
    return full, tail, step, resume_s


def phase_checkpoint(smi):
    """Checkpoint/resume at the Sec. V configuration (cyclic, N = 6,
    J = 3, 6000^2, S = 1, the churn script, verify="exact"), both executor
    modes, fuse_steps in {1, 4}: an 8-step run is cut after step 5 (the
    snapshot every 2 steps leaves step 4 as LATEST), resumed in a fresh
    engine, and its tail must be bitwise the uninterrupted run (fused
    windows recompile from the restored state). Then a checkpoint written
    on the card at 768^2 (MAN, N = 4) restores into a device="cpu" engine
    and continues bitwise the host's uninterrupted run."""
    import shutil
    import tempfile

    from repro_torch.runtime import make_exact_matrix

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ckpt_", dir=os.path.join(ROOT, "build"))
    try:
        x = make_exact_matrix(DIM, 0)
        for seg in (None, "auto"):
            for fuse in (1, 4):
                gc.collect()
                full, tail, step, resume_s = _ckpt_drill(
                    x, "cyclic", N_WORKERS, BASE_SPEEDS, BLOCK_ROWS, SCRIPT,
                    seg, fuse, os.path.join(root, f"{seg}_{fuse}"), None,
                    None)
                a, b = full.result, tail.result
                if not (step == 4 and np.array_equal(a.eigvec, b.eigvec)
                        and a.residuals[step:] == b.residuals):
                    raise AssertionError(
                        f"checkpoint segmented={seg} fuse={fuse}: resumed "
                        f"tail from step {step} != the uninterrupted run")
                emit({"phase": "checkpoint", "placement": "cyclic", "S": 1,
                      "segmented": seg, "fuse_steps": fuse, "cut": CKPT_CUT,
                      "resumed_from": step, "tail_steps": len(b.reports),
                      "bitwise_uninterrupted": True, "resume_s": resume_s,
                      "nvidia_smi": smi})
                del full, tail
        x = make_exact_matrix(768, 0)
        script4 = {0: ((3,), ()), 1: ((1,), (3,)), 2: ((), (1,)),
                   4: ((2,), ()), 5: ((), (2,))}
        for seg in (None, "auto"):
            full, tail, step, _ = _ckpt_drill(
                x, "man", 4, [1000.0, 1300.0, 1700.0, 2200.0], 16, script4,
                seg, 1, os.path.join(root, f"host_{seg}"), "cuda", "cpu")
            if not (np.array_equal(full.result.eigvec, tail.result.eigvec)
                    and full.result.residuals[step:]
                    == tail.result.residuals):
                raise AssertionError(
                    f"card checkpoint resumed on the host, segmented={seg}: "
                    f"tail != the host's uninterrupted run")
        emit({"phase": "checkpoint_checks", "resume_bitwise": True,
              "card_to_host_bitwise": True,
              "phase_s": time.perf_counter() - t_phase, "nvidia_smi": smi})
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------- #
# Faults + integrity at Sec. V
# ---------------------------------------------------------------------- #
FAULT_STEP, CRASH_STEP, UNVERIFIED_STEP = 4, 6, 5
FAULT_GRID = (("barrier", 1), ("first", 4))

def timeout_s(dim: int) -> float:
    """A dispatch deadline only worker 0 misses: at step 0 the planner still
    believes every speed equal (no prior), so each of the 5 live workers
    gets ~2 * dim / 5 rows, and worker 0 (1000 rows/s) takes ~dim / 2500 s
    (2.4 s at 6000^2) against worker 1's ~dim / 5000 s."""
    return dim / 3000.0

PARITY_FAULT_SEED = 4


def _record_plans(runner, plans):
    """Append each adopted plan entry to ``plans`` (one per executed step,
    in step order, on runs without a retry)."""
    adopt = runner._adopt_plan

    def recorded():
        got = adopt()
        plans.append(got[0])
        return got

    runner._adopt_plan = recorded


def _time_integrity(runner, times):
    """Host seconds of every call of the runner's integrity checker's
    audit and Freivalds checks, by method name; the runner's whole tile
    audit per verified step in ms by CUDA events (``card_audit``: one
    tile_checksum launch, the device-to-host copy of the checksums, the
    comparison and any repair); and each checksum of the card's buffer
    the runner asks for (``card_sums``, one kernel launch each)."""
    chk = runner._integrity
    if chk is None:
        return
    for name in ("audit_tiles", "check_output", "check_chunks", "locate"):
        def timed(*a, _fn=getattr(chk, name), _name=name, **k):
            t0 = time.perf_counter()
            got = _fn(*a, **k)
            times.setdefault(_name, []).append(time.perf_counter() - t0)
            return got
        setattr(chk, name, timed)
    audit, sums = runner._audit_and_restage, runner._card_sums

    def card_audit(t):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        audit(t)
        end.record()
        end.synchronize()
        times.setdefault("card_audit", []).append(start.elapsed_time(end))

    def card_sums():
        times.setdefault("card_sums", []).append(1)
        return sums()

    runner._audit_and_restage, runner._card_sums = card_audit, card_sums


def _corrupt_card_tile(runner, step, n, keep):
    """Before the audit of ``step``, flip bits in the first elements of
    worker ``n``'s first stored tile on the card only (the host copy is
    untouched): the same flip as the ``tile_corruption`` fault."""
    audit = runner._audit_and_restage

    def corrupt_then_audit(t):
        if t == step:
            slot_of = runner._staged.slot_of[n]
            slot = int(slot_of[int(np.flatnonzero(slot_of >= 0)[0])])
            bits = runner._staged_dev[n, slot].view(torch.int32).view(-1)[:3]
            bits ^= 1 << 22
            keep["card_corrupted"] = (n, slot)
        return audit(t)

    runner._audit_and_restage = corrupt_then_audit


def _tile_fault_moves_output(runner, entry, bad, n, w) -> bool:
    """Would ``tile_corruption`` of worker ``n`` change this step's output
    (straggler set ``bad``, operand ``w``)? It flips bits in the first
    elements of the first row of ``n``'s first stored tile: ``n`` must
    deliver that row, and the flip must move the row's product with ``w``
    by more than fp32 rounding (a flipped zero is a denormal)."""
    from repro_torch.faults.integrity import corrupt_tile
    from repro_torch.runtime import refresh_include

    bp = entry.block
    slot_of = runner._staged.slot_of[n]
    slot = int(slot_of[int(np.flatnonzero(slot_of >= 0)[0])])
    inc = refresh_include(bp, entry.step_plan.plan, tuple(sorted(bad)))
    if not ((inc[n] > 0) & (bp.blk_slot[n] == slot) & (bp.blk_off[n] == 0)
            & (bp.blk_seg_t[n] >= 0)).any():
        return False
    row = np.array(runner._staged.staged[n, slot, 0])
    flipped = row.copy()
    corrupt_tile(flipped)
    moved = (flipped.astype(np.float64) - row) @ np.asarray(w, np.float64)
    return abs(float(moved)) >= 2.0 ** -10


def phase_elastic_faults(counters, smi, tc_ms):
    """Faults and integrity at the Sec. V configuration (cyclic, N = 6,
    J = 3, 6000^2, 8 steps of the churn script, verify="exact" at every
    step), both executor modes, no forced stragglers. Covered faults at
    S = 1 under (barrier, 1) and (first, 4) — every dispatch, planning and
    corruption kind and a dispatch timeout — and the corruption kinds in
    segmented (barrier, 4) (the window graph): bitwise the clean run, no
    recovery, the reference's action. Uncovered faults at S = 0: demoted
    and re-executed to the clean bits. After every tile fault the staged
    buffer on the card is the one staged (same address) and equals the
    host copy; a tile corrupted at a step verify_results="sample" skips
    reaches the kernel (per-block stepwise, and segmented through the
    graph). Exact launch counts in every run: a barrier quarantine adds
    one executor call (the plan's real blocks per-block, one
    usec_segmented segmented), first-arrival dispatches no silent worker,
    the window graph captures once and replays once a window, and a
    window's corrupt row chunk is recomputed from a replica tile on the
    card by one usec_matvec launch. Then a
    seeded fault schedule at 768^2, card against host. ``tc_ms`` is the
    tile_checksum kernel's time from its kernel phase: the checks report
    its share of the card audit per verified step. Returns the launches of
    these runs."""
    from repro_torch.faults import ChaosPlan, FaultSpec, IntegrityChecker
    from repro_torch.runtime import make_exact_matrix

    t_phase = time.perf_counter()
    x = make_exact_matrix(DIM, 0)
    totals = {name: 0 for name in counters}

    def go(seg, arrival, fuse, s_tol=1, faults=(), cfg=None,
           card_corrupt=None):
        # Earlier runs' runners hold 432 MB on the card each and sit in
        # reference cycles (their wrapped methods): free them first.
        gc.collect()
        tally = {"worker_calls": 0, "worker_blocks": 0, "plan_blocks": 0,
                 "plan_loaded": 0}
        keep, plans, times, operands = {}, [], {}, []

        def on_runner(r):
            keep.update(runner=r, ptr=r._staged_dev.data_ptr())
            _expectations(r, tally)
            _record_plans(r, plans)
            _time_integrity(r, times)
            if card_corrupt is not None:
                _corrupt_card_tile(r, *card_corrupt, keep)
            consume = r.workload.consume

            def recorded(y, w):
                operands.append(np.array(w))
                return consume(y, w)

            r.workload.consume = recorded

        plan = ChaosPlan([FaultSpec(*f) for f in faults]) if faults else None
        reset_launches(counters)
        t0 = time.perf_counter()
        run = power_iteration(
            None, x, "cyclic", REPLICATION, s_tol, seg, N_WORKERS,
            BASE_SPEEDS, SCRIPT, STEPS, BLOCK_ROWS, arrival=arrival,
            fuse_steps=fuse, inject=False, on_runner=on_runner, faults=plan,
            cfg=cfg)
        res = run.result
        run_s = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in counters.items()}
        for n, v in launches.items():
            totals[n] += v
        cell = (f"elastic_faults segmented={seg} {arrival}/{fuse} S={s_tol} "
                f"{faults} {cfg}")
        win = tally.get("window")
        repaired = keep["runner"].integrity["repaired_rows"] // BLOCK_ROWS
        check_launches(cell, seg, arrival, fuse, tally, launches, repaired)
        # tile_checksum: one launch at staging when the checker is on, then
        # one per checksum of the card's buffer (each audit, and a fused
        # window's donor search).
        checked = keep["runner"]._integrity is not None
        if launches["tile_checksum"] != checked + len(
                times.get("card_sums", [])) or (
                checked and len(times.get("card_audit", []))
                != run.integrity["tile_audits"]):
            raise AssertionError(
                f"{cell}: {launches['tile_checksum']} tile_checksum "
                f"launches, {len(times.get('card_sums', []))} checksum "
                f"calls, {run.integrity['tile_audits']} audits")
        if fuse > 1 and run.integrity.get("quarantined") and not repaired:
            raise AssertionError(f"{cell}: a window quarantine recomputed "
                                 f"no row chunk")
        if run.executor_cache_size != 1 or len(run.reports) != STEPS \
                or not np.all(np.isfinite(res.eigvec)):
            raise AssertionError(
                f"{cell}: executor_cache_size {run.executor_cache_size}, "
                f"{len(run.reports)} steps")
        return {"res": res, "run": run, "runner": keep["runner"],
                "ptr": keep["ptr"], "plans": plans, "times": times,
                "card_corrupted": keep.get("card_corrupted"),
                "operands": operands,
                "tally": tally, "launches": launches, "run_s": run_s,
                "cell": cell, "windows": win.calls if win else None}

    def staged_intact(r, cell):
        runner = r["runner"]
        if runner._staged_dev.data_ptr() != r["ptr"] or not torch.equal(
                runner._staged_dev.cpu(),
                torch.from_numpy(runner._staged.staged)):
            raise AssertionError(f"{cell}: staged buffer re-bound or != host")

    def actions(r):
        return [rec.action for rec in r["run"].fault_records]

    def emit_run(kind, r, clean, step):
        walls = [rep.wall_s for rep in clean["run"].reports]
        times = r["times"]
        checks = times.get("check_output", []) + times.get("check_chunks", [])
        recs = r["run"].fault_records
        emit({"phase": "elastic_faults", "cell": r["cell"], "kind": kind,
              "actions": actions(r),
              "workers": [rec.spec.worker for rec in recs],
              "recoveries": r["run"].recoveries,
              "integrity": r["run"].integrity,
              "fault_step": step,
              "fault_step_wall_ms": (1e3 * r["run"].reports[step].wall_s
                                     if step is not None else None),
              "clean_median_wall_ms": 1e3 * float(np.median(walls)),
              "dispatches": r["runner"].device_dispatches,
              "clean_dispatches": clean["runner"].device_dispatches,
              "windows": r["windows"],
              "recomputed_chunks": (r["runner"].integrity["repaired_rows"]
                                    // BLOCK_ROWS),
              "recover_s": [rec.recover_s for rec in recs
                            if rec.action == "demoted"],
              "audit_ms_per_call": (1e3 * float(np.mean(
                  times["audit_tiles"])) if "audit_tiles" in times else None),
              "card_audit_ms_per_verified_step": (
                  float(np.mean(times["card_audit"]))
                  if "card_audit" in times else None),
              "freivalds_ms_per_check": (1e3 * float(np.mean(checks))
                                         if checks else None),
              "launches": r["launches"], "run_s": r["run_s"],
              "nvidia_smi": smi})

    def winners(clean, step, s_tol):
        """Workers delivering rows at ``step`` of the clean run, most
        blocks first."""
        runner, e = clean["runner"], clean["plans"][step]
        bad = set(clean["run"].reports[step].straggled)
        ws = [n for n in runner.membership if n not in bad
              and runner._first_winner_row(e, bad, n) is not None]
        return sorted(ws, key=lambda n: -int(e.block.n_blocks[n]))

    audit_ms = {"card": [], "host": []}

    def card_only(seg, arrival, fuse, clean, cfg, audits):
        """Corrupt one tile of the card's copy alone at FAULT_STEP (a tile
        that step reads, so an unrepaired flip would move the output): the
        card audit finds it and re-stages it in place from a clean card
        donor, the host copy is untouched, and the run is bitwise the
        clean run."""
        runner = clean["runner"]
        rep = clean["run"].reports[FAULT_STEP]
        target = next(n for n in rep.available if _tile_fault_moves_output(
            runner, clean["plans"][FAULT_STEP], set(rep.straggled), n,
            clean["operands"][FAULT_STEP]))
        r = go(seg, arrival, fuse, cfg=cfg,
               card_corrupt=(FAULT_STEP, target))
        rn, integ = r["runner"], r["run"].integrity
        chk = rn._integrity
        t0 = time.perf_counter()
        host_clean = chk.tile_mismatches(rn._staged.staged) == []
        audit_ms["host"].append(1e3 * (time.perf_counter() - t0))
        audit_ms["card"] += r["times"]["card_audit"]
        if not (r["card_corrupted"] and host_clean
                and (integ["restaged"], integ["tile_audits"]) == (1, audits)
                and _same(r["res"], clean["res"], sets=False)):
            raise AssertionError(
                f"{r['cell']}: card-only corruption of worker {target}: "
                f"{integ}, host copy clean {host_clean}, bitwise "
                f"{_same(r['res'], clean['res'], sets=False)}")
        staged_intact(r, r["cell"])
        emit_run("card_only_tile_corruption", r, clean, FAULT_STEP)

    checker_s = None
    n_runs = 0
    for seg in (None, "auto"):
        cleans = {}
        for arrival, fuse in FAULT_GRID:
            verify = "always" if (arrival, fuse) == ("barrier", 1) \
                else "sample"
            clean = cleans[arrival] = go(seg, arrival, fuse,
                                         cfg={"verify_results": verify})
            n_runs += 1
            integ = clean["run"].integrity
            if integ["sketch_failures"] != 0 or integ["checks"] <= 0:
                raise AssertionError(f"{clean['cell']}: clean {integ}")
            emit_run("clean", clean, clean, None)
            if checker_s is None:
                rn = clean["runner"]
                t0 = time.perf_counter()
                IntegrityChecker(
                    x, staged=rn._staged.staged, slot_of=rn._staged.slot_of,
                    holders=rn.placement.holders, block_rows=BLOCK_ROWS,
                    linear=True, exact=True)
                checker_s = time.perf_counter() - t0
            t4 = winners(clean, FAULT_STEP, 1)[0]
            t6 = winners(clean, CRASH_STEP, 1)[0]
            sample = {"verify_results": "sample"}
            covered = {
                "worker_crash": ([("worker_crash", CRASH_STEP, t6)], None,
                                 CRASH_STEP, ["masked"]),
                "result_drop": ([("result_drop", CRASH_STEP, t6)], None,
                                CRASH_STEP, ["masked"]),
                "speed_report_loss": ([("speed_report_loss", FAULT_STEP)],
                                      None, FAULT_STEP, ["report_dropped"]),
                "stale_plan_table": ([("stale_plan_table", FAULT_STEP)],
                                     None, FAULT_STEP, ["invalidated"]),
                "tile_corruption": ([("tile_corruption", FAULT_STEP, t4)],
                                    sample, FAULT_STEP, ["restaged"]),
                "result_corruption": ([("result_corruption", FAULT_STEP,
                                        t4)], sample, FAULT_STEP,
                                      ["quarantined"]),
                "dispatch_timeout": ((), {"dispatch_timeout": timeout_s(DIM)}, 0,
                                     None),
            }
            for kind, (faults, cfg, step, want) in covered.items():
                r = go(seg, arrival, fuse, faults=faults, cfg=cfg)
                n_runs += 1
                acts = actions(r)
                if kind == "dispatch_timeout":
                    ok = (acts and set(acts) == {"masked"} and
                          {rec.spec.worker for rec in r["run"].fault_records}
                          == {0})
                else:
                    ok = acts == want
                sketch = r["run"].integrity["sketch_failures"]
                if not (ok and _same(r["res"], clean["res"], sets=False)
                        and r["run"].recoveries == 0
                        and sketch == (kind == "result_corruption")):
                    raise AssertionError(
                        f"{r['cell']}: {kind} actions {acts}, recoveries "
                        f"{r['run'].recoveries}, sketch failures {sketch}, "
                        f"bitwise {_same(r['res'], clean['res'], False)}")
                if kind == "tile_corruption":
                    staged_intact(r, r["cell"])
                if kind == "result_corruption" and fuse == 1:
                    # The quarantine's masked re-dispatch: one more executor
                    # call with the plan's real blocks.
                    blocks = [int(e.block.n_blocks.sum()) for e in r["plans"]]
                    tl = r["tally"]
                    if (tl["step_calls"], tl["step_blocks"],
                            r["runner"].device_dispatches) != (
                            STEPS + 1, sum(blocks) + blocks[FAULT_STEP],
                            STEPS + 1):
                        raise AssertionError(f"{r['cell']}: re-dispatch {tl}")
                emit_run(kind, r, clean, step)
            if (arrival, fuse) == ("barrier", 1):
                card_only(seg, arrival, fuse, clean,
                          {"verify_results": "always"}, STEPS)
                n_runs += 1

            # Uncovered at S = 0: demote, replan, re-execute.
            clean0 = go(seg, arrival, fuse, s_tol=0)
            n_runs += 1
            u6 = winners(clean0, CRASH_STEP, 0)[0]
            u4 = winners(clean0, FAULT_STEP, 0)[0]
            for kind, faults, cfg, step, target in (
                    ("worker_crash", [("worker_crash", CRASH_STEP, u6)],
                     None, CRASH_STEP, u6),
                    ("result_corruption",
                     [("result_corruption", FAULT_STEP, u4)], sample,
                     FAULT_STEP, u4)):
                r = go(seg, arrival, fuse, s_tol=0, faults=faults, cfg=cfg)
                n_runs += 1
                run = r["run"]
                # A fused window recomputes a corrupt chunk from a replica
                # tile instead (the reference's behavior; on the card one
                # usec_matvec launch a chunk, counted by check_launches).
                in_window = kind == "result_corruption" and fuse > 1
                want = (["quarantined"], 0) if in_window \
                    else (["demoted"], 1)
                later = [rep.available for rep in run.reports[step + 1:]]
                ok = ((actions(r), run.recoveries) == want
                      and _same(r["res"], clean0["res"], sets=False)
                      and (in_window or (
                          all(target not in a for a in later)
                          and run.fault_records[0].recover_s > 0)))
                if not ok:
                    raise AssertionError(
                        f"{r['cell']}: uncovered {kind} {actions(r)}, "
                        f"recoveries {run.recoveries}, available {later}")
                emit_run(f"uncovered_{kind}", r, clean0, step)

            if arrival == "first":
                # First-arrival stepwise: the crashed worker is never
                # dispatched at its step.
                r = go(seg, "first", 1, faults=[
                    ("worker_crash", CRASH_STEP, t6)])
                n_runs += 1
                tl = r["tally"]
                if tl["worker_calls"] != tl["plan_loaded"] - 1 \
                        or actions(r) != ["masked"]:
                    raise AssertionError(f"{r['cell']}: dispatches {tl}")
                emit_run("first_stepwise_worker_crash", r, r, CRASH_STEP)

        # Segmented (barrier, 4): the corruption kinds through the window
        # graph; then, once per executor mode, a tile corrupted at a step
        # verify_results="sample" skips must reach the kernel.
        if seg is None:
            base = cleans["barrier"]
        else:
            base = go(seg, "barrier", 4, cfg={"verify_results": "sample"})
            n_runs += 1
            t4 = winners(base, FAULT_STEP, 1)[0]
            for kind, action in (("tile_corruption", "restaged"),
                                 ("result_corruption", "quarantined")):
                r = go(seg, "barrier", 4, faults=[(kind, FAULT_STEP, t4)],
                       cfg={"verify_results": "sample"})
                n_runs += 1
                if actions(r) != [action] or r["run"].recoveries != 0 \
                        or not _same(r["res"], base["res"], sets=False):
                    raise AssertionError(f"{r['cell']}: {actions(r)}")
                if kind == "tile_corruption":
                    staged_intact(r, r["cell"])
                emit_run(kind, r, base, FAULT_STEP)
            # verify_results="sample" audits steps 0 and 4 of the 8.
            card_only(seg, "barrier", 4, base, {"verify_results": "sample"},
                      2)
            n_runs += 1
        runner = base["runner"]
        tu = next(n for n in runner.membership if _tile_fault_moves_output(
            runner, base["plans"][UNVERIFIED_STEP],
            set(base["run"].reports[UNVERIFIED_STEP].straggled), n,
            base["operands"][UNVERIFIED_STEP]))
        r = go(seg, "barrier", 4 if seg else 1,
               faults=[("tile_corruption", UNVERIFIED_STEP, tu)],
               cfg={"verify_results": "sample", "verify": None})
        n_runs += 1
        got, want = r["res"].residuals, base["res"].residuals
        # The step's output (its residual) leaves the clean run's; the
        # quantized eigvec may round back onto the clean grid point.
        if got[:UNVERIFIED_STEP] != want[:UNVERIFIED_STEP] \
                or got[UNVERIFIED_STEP] == want[UNVERIFIED_STEP] \
                or r["run"].fault_records:
            raise AssertionError(
                f"{r['cell']}: unverified tile corruption did not reach "
                f"the kernel")
        staged_intact(r, r["cell"])
        emit_run("unverified_tile_corruption", r, base, UNVERIFIED_STEP)
    parity = faults_parity()
    emit({"phase": "elastic_faults_checks", "runs": n_runs,
          "covered_bitwise_clean": True, "uncovered_demoted_bitwise": True,
          "executor_cache_size_1": True, "staged_buffer_in_place": True,
          "unverified_corruption_reaches_kernel": True,
          "launch_counts_exact": True, "card_vs_host_seeded": parity,
          "card_only_corruption_restaged_in_place": True,
          "card_audit_ms_per_verified_step": audit_ms["card"],
          # The median audit is one that repaired nothing (one audit a run
          # re-stages 24 MB from the host copy).
          "card_audit_ms_median": float(np.median(audit_ms["card"])),
          "tile_checksum_ms": tc_ms,
          "tile_checksum_share_of_card_audit": (
              tc_ms / float(np.median(audit_ms["card"]))),
          "host_zlib_audit_ms": audit_ms["host"],
          "checker_build_s": checker_s,
          "phase_s": time.perf_counter() - t_phase, "nvidia_smi": smi})
    return totals


def faults_parity():
    """One seeded fault schedule over every kind (768^2, MAN, N = 4, S = 1,
    decentral re-planning, verify_results="always"): the port on the card
    against the port on the host, bitwise eigvec, residuals, realized sets
    and fault records, stepwise barrier and fused first-arrival, both
    executor modes. Returns the schedule's kinds."""
    from repro_torch.faults import FAULT_KINDS, ChaosPlan
    from repro_torch.runtime import make_exact_matrix

    x = make_exact_matrix(768, 0)
    script4 = {0: ((3,), ()), 1: ((1,), (3,)), 2: ((), (1,)),
               4: ((2,), ()), 5: ((), (2,))}
    plan = ChaosPlan.generate(STEPS, 4, n_faults=3, seed=PARITY_FAULT_SEED,
                              kinds=FAULT_KINDS)
    for mode in ("barrier", "fused4_first"):
        kw = dict(PARITY_MODES[mode])
        kw["inject"] = False
        for seg in (None, "auto"):
            res = {}
            for dev in ("cpu", "cuda"):
                res[dev] = power_iteration(
                    dev, x, "man", 3, 1, seg, 4,
                    [1000.0, 1300.0, 1700.0, 2200.0], script4, STEPS, 16,
                    replan="decentral", faults=plan,
                    cfg={"verify_results": "always"}, **kw)
            a, b = res["cpu"], res["cuda"]
            recs = [[(r.spec.step, r.spec.kind, r.spec.worker, r.action)
                     for r in e.fault_records] for e in (a, b)]
            if not (_same(a.result, b.result) and recs[0] == recs[1]
                    and a.recoveries == b.recoveries
                    and a.integrity == b.integrity):
                raise AssertionError(
                    f"faulted card != host at {mode}, segmented={seg}: "
                    f"{recs}")
    return [f.kind for f in plan]


def phase_elastic_profile(smi):
    """One fused segmented run (cyclic, S = 0, windows of 4) under
    torch.profiler, after a warm run that captured the window graph: the
    window's wall, the device time, the busy share (beside the stepwise
    segmented mode's in the profile phase), and one graph replay timed alone
    with CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime import make_exact_matrix

    x = make_exact_matrix(DIM, 0)
    keep = {}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    res = power_iteration(
        None, x, "cyclic", REPLICATION, 0, "auto", N_WORKERS, BASE_SPEEDS,
        SCRIPT, STEPS, BLOCK_ROWS, profiler=prof, fuse_steps=4,
        on_warm=lambda r: keep.update(runner=r, warm=r.device_dispatches)
    ).result
    runner = keep["runner"]
    entries = sorted(
        ((float(getattr(e, "self_device_time_total", 0) or 0), e.key,
          int(e.count)) for e in prof.key_averages()
         if str(e.device_type).endswith("CUDA")), reverse=True)
    dev_us = sum(e[0] for e in entries)
    exec_s = sum(r.wall_s for r in res.reports)
    windows = runner.device_dispatches - keep["warm"]   # the profiled run
    replay_ms = cuda_ms(runner._fused._graph.replay, 20)
    emit({"phase": "elastic_profile", "placement": "cyclic", "S": 0,
          "segmented": "auto", "fuse_steps": 4, "steps": len(res.reports),
          "windows": windows,
          "executor_wall_ms_per_window": 1e3 * exec_s / windows,
          "executor_wall_ms_per_step": 1e3 * exec_s / len(res.reports),
          "device_ms_per_step": 1e-3 * dev_us / len(res.reports),
          "device_busy_share_of_executor_wall":
              (1e-6 * dev_us / exec_s) if exec_s else None,
          "graph_replay_ms_cuda_events": replay_ms,
          "graph_replays": runner.window_graph_replays,
          "top_device": [[k[:60], us, n] for us, k, n in entries[:6]
                         if us > 0], "nvidia_smi": smi})


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
                              BLOCK_ROWS, profiler=prof).result
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
# The model stack's serving path: glm4-9b and deepseek-moe-16b prefill +
# decode
# ---------------------------------------------------------------------- #
MODEL_ARCH, MODEL_BATCH, PROMPT_LEN, DECODE_STEPS = "glm4-9b", 1, 8192, 32
# The MoE model, at full width and depth with the same cell sizes.
MOE_ARCH = "deepseek-moe-16b"
# Every arch the model path serves at full width and depth, in turn, with
# the same cell: the dense and MoE attention stacks, the Griffin hybrid
# (RG-LRU + local attention) and the attention-free Mamba-2 SSD stack.
MODEL_ARCHS = (MODEL_ARCH, MOE_ARCH, "recurrentgemma-2b", "mamba2-370m")
# The exact parameter count of the reference's init of each (its
# ``jax.eval_shape``; ``cfg.n_params()`` is an analytic approximation that
# misses the RG-LRU gates and the SSD norm). tests/test_torch_models.py
# holds this table to the reference.
EXACT_PARAMS = {"glm4-9b": 9399767040, "deepseek-moe-16b": 16879568896,
                "recurrentgemma-2b": 2894528000, "mamba2-370m": 368227840}
ATTENTION_KINDS = ("attn", "lattn")
# (share of the largest |output|) of the recurrent state handoff: one
# layer in fp32 with TF32 off, a decode step after a P-token prefill
# against row P+1 of a (P+1)-token prefill. Both sides compute the same
# function in fp32 and sum in another order (the chunked or log-depth scan
# against the one-step recurrence, an (S, K) GEMM against a (1, K) GEMV).
HANDOFF_TOL = 1e-4
PROFILE_DECODE_STEPS = 8
# (rtol, atol as a share of the largest |output|) of the MoE FFN's main path
# against its one-hot plain version in bf16. Both read the same bf16 inputs
# and routing; the experts' products and the combine round to bf16 in
# another order (cuBLAS picks its own sum order per shape), so outputs may
# differ by a few bf16 ulps of the largest value: 1e-2 is about 2.5 ulps.
MOE_TOL = (1e-2, 1e-2)
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
     (1, 4, 2, 100, 60, 64, True, None, torch.float32),
     # GQA 16:1, sq not a multiple of the 128-row query block, skv > sq;
     # a causal offset (130) that is not a multiple of the KV tile.
     (1, 16, 1, 200, 333, 128, True, None, torch.bfloat16),
     (1, 8, 2, 1000, 1130, 128, True, None, torch.bfloat16)]
# One glm4-9b layer's prefill attention at the model path's prompt length,
# and one deepseek-moe-16b layer's (MHA: 16 query and 16 KV heads).
FLASH_LAYER = (1, 32, 2, PROMPT_LEN, PROMPT_LEN, 128, True, None,
               torch.bfloat16)
FLASH_LAYER_MHA = (1, 16, 16, PROMPT_LEN, PROMPT_LEN, 128, True, None,
                   torch.bfloat16)
# One recurrentgemma-2b local-attention layer: head_dim 256, GQA 10:1, a
# 2048-token sliding window.
FLASH_LAYER_WINDOW = (1, 10, 1, PROMPT_LEN, PROMPT_LEN, 256, True, 2048,
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
    route = "launches_tc" if dt == torch.bfloat16 else "launches_ffma"
    before = getattr(flash_attention_cuda, route)
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    again = flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    if getattr(flash_attention_cuda, route) != before + 2:
        raise AssertionError(f"flash_attention at {case} did not go through "
                             f"{route}")
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


def sdpa_call(q, k, v, causal: bool, window):
    """(the library call computing the layer's function, the SDPA backend
    it runs on). A windowed layer gives SDPA an explicit boolean
    causal+window mask, which takes it off its flash backend."""
    import torch.nn.functional as F

    mask = None
    if window is not None:
        sq, skv = q.shape[-2], k.shape[-2]
        q_pos = torch.arange(sq, device=q.device)[:, None] + skv - sq
        k_pos = torch.arange(skv, device=q.device)[None, :]
        mask = (k_pos > q_pos - window) & (k_pos <= q_pos if causal else True)
    kw = dict(attn_mask=mask, is_causal=causal and mask is None,
              enable_gqa=True)
    choice = getattr(torch, "_fused_sdp_choice", None)
    backend = "unknown"
    if choice is not None:
        idx = choice(q, k, v, mask, 0.0, kw["is_causal"], enable_gqa=True)
        backend = torch.nn.attention.SDPBackend(idx).name
    return (lambda: F.scaled_dot_product_attention(q, k, v, **kw)), backend


def flash_layer(case, dev, seed):
    """One full-width layer's prefill attention at ``case``: the kernel
    against its plain version, then the kernel's, the plain version's and
    one library call's (SDPA, on the backend named) times, all three on
    the same function (causal, and the window where the layer has one),
    and the bound."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda,
        flash_attention_plain,
    )

    err = flash_check(case, dev, seed)
    b, h, hk, sq, skv, d, causal, window, dt = case
    q, k, v = flash_operands(case, dev, seed)
    pairs = b * h * live_pairs(sq, skv, causal, window)
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    n_flops = 4 * d * pairs
    bound, by = bound_ms(n_bytes, n_flops, BF16_FLOPS_PER_S)
    kern = timed(lambda: flash_attention_cuda(q, k, v, causal=causal,
                                              window=window), 10,
                 "flash_tc_kernel", bound)
    plain = timed(lambda: flash_attention_plain(q, k, v, causal=causal,
                                                window=window), 3,
                  bound=bound)
    sdpa, backend = sdpa_call(q, k, v, causal, window)
    lib = timed(sdpa, 10, bound=bound)
    del q, k, v, sdpa
    torch.cuda.empty_cache()
    return {"shape": list(case[:8]), "max_abs_err": err, "kernel": kern,
            "plain": plain, "library": lib, "sdpa_backend": backend,
            "live_pairs": pairs,
            "flops": n_flops, "bytes": n_bytes, "bound_ms": bound,
            "bound_by": by,
            "bound_ms_fp32_ffma": bound_ms(n_bytes, n_flops,
                                           FP32_FLOPS_PER_S)[0],
            "kernel_tflops": n_flops / kern["ms"] / 1e9,
            # P.V runs twice (P_hi and P_lo): 6*d FLOPs issued per live pair.
            "kernel_tflops_issued_6d": 1.5 * n_flops / kern["ms"] / 1e9}


def phase_flash(dev, paths):
    """The flash kernels against their plain version at the test cases,
    every head_dim in both dtypes (bf16: tensor-core kernel, fp32: FFMA
    kernel), one full-width glm4-9b layer (GQA 16), one deepseek-moe-16b
    layer (MHA) and one recurrentgemma-2b local-attention layer (d 256, GQA
    10, window 2048); each layer's times: kernel, plain version, and one library
    call (SDPA) as a yardstick; and both kernels' ptxas registers and
    spills. The kernels line takes the glm4-9b layer's numbers."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    cases = FLASH_CASES + FLASH_HEAD_DIM_CASES
    routes0 = (flash_attention_cuda.launches_tc,
               flash_attention_cuda.launches_ffma)
    errs = {str(dt).replace("torch.", ""): max(
        flash_check(c, dev, i) for i, c in enumerate(cases) if c[8] == dt)
        for dt in ATTN_TOL}
    layer = flash_layer(FLASH_LAYER, dev, 99)
    mha = flash_layer(FLASH_LAYER_MHA, dev, 98)
    windowed = flash_layer(FLASH_LAYER_WINDOW, dev, 97)
    routes = {"launches_tc": flash_attention_cuda.launches_tc - routes0[0],
              "launches_ffma": flash_attention_cuda.launches_ffma - routes0[1]}
    emit({"phase": "kernel", "name": "flash_attention",
          "cases": len(cases) + 3, "max_abs_err_cases": errs,
          "rtol_atol": {str(dt).replace("torch.", ""): tol
                        for dt, tol in ATTN_TOL.items()},
          "bitwise_run_to_run": True, "dtype": "bfloat16",
          "layer_glm4_9b": layer, "layer_deepseek_moe_16b_mha": mha,
          "layer_recurrentgemma_2b_lattn": windowed,
          "check_launches": routes,
          "ptxas": {stem: ptxas_report(paths[stem])
                    for stem in ("flash_attention_tc", "flash_attention")}})
    return {"route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_tc.cu",
            "replaces": "src/repro/kernels/flash_attention.py:106",
            "max_abs_err": layer["max_abs_err"], **layer["kernel"],
            "plain_ms": layer["plain"]["ms"], "bound_ms": layer["bound_ms"],
            "bound_by": layer["bound_by"],
            "library_ms": layer["library"]["ms"]}


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


def attention_layer_count(cfg) -> int:
    """The number of attention (``attn``/``lattn``) layers in ``cfg``'s
    stack: one flash launch each in a long prefill."""
    from repro_torch.models.transformer import stack_layout

    n_rep, extra_kinds = stack_layout(cfg)
    return (n_rep * sum(k in ATTENTION_KINDS for k in cfg.layer_pattern)
            + sum(k in ATTENTION_KINDS for k in extra_kinds))


def first_layer(params, cfg, kinds):
    """(kind, name, params) of the first layer in stack order whose kind is
    in ``kinds``, or None."""
    from repro_torch.models.transformer import stack_layout, tree_map

    n_rep, extra_kinds = stack_layout(cfg)
    stack = params["stack"]
    for pos, kind in enumerate(cfg.layer_pattern if n_rep else ()):
        if kind in kinds:
            return (kind, f"blocks[{pos}][0]",
                    tree_map(lambda t: t[0], stack["blocks"][pos]))
    for i, kind in enumerate(extra_kinds):
        if kind in kinds:
            return kind, f"extras[{i}]", stack["extras"][i]
    return None


def phase_model_path(dev, counters, smi, arch):
    """``arch`` at full width and depth through
    ``repro_torch.launch.serve.generate``: weights from a seed, an
    8192-token prompt, restage, 32 greedy decode steps. The parameter count
    is the reference init's exact count (:data:`EXACT_PARAMS`). Every
    attention layer of the prefill launches the flash kernel once, on the
    tensor-core route (bf16); recurrent layers and decode never do. Then
    the first attention layer's prefill attention (with its window), kernel
    route against the plain ``chunked_attention``; for an MoE model layer
    0's MoE FFN against its plain version (:func:`moe_layer_check`); for a
    recurrent model its first rglru or ssm layer's state handoff
    (:func:`state_handoff`). Returns the main path's launch counts and what
    the profile phase reuses."""
    import dataclasses

    from repro_torch.configs import demo_batch, get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model, moe, param_count
    from repro_torch.models.attention import (
        attention_prefill,
        chunked_attention,
        long_attention,
        qkv,
    )
    from repro_torch.models.layers import apply_norm

    cfg = get_config(arch)
    n_attn = attention_layer_count(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    bundle = build_model(cfg, device=dev)
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if param_count(params) != EXACT_PARAMS[arch]:
        raise AssertionError(f"{arch}: {param_count(params)} parameters, "
                             f"the reference's init has {EXACT_PARAMS[arch]}")
    batch = demo_batch(cfg, "prefill", MODEL_BATCH, PROMPT_LEN, seed=0)
    tally = {"prefill": 0, "decode": 0}
    counted = dataclasses.replace(
        bundle, prefill=_counting(bundle.prefill, tally, "prefill"),
        decode_step=_counting(bundle.decode_step, tally, "decode"))
    # Each MoE routing's token count, capacity and dropped (token, choice)
    # pairs (a device scalar: one small reduction a chunk, read at the end).
    routed, route = [], moe.route

    def logged_route(router, xt, cfg_):
        r = route(router, xt, cfg_)
        routed.append((xt.shape[0], r.capacity, (~r.keep).sum()))
        return r

    reset_launches(counters)
    moe.route = logged_route
    try:
        out = generate(counted, params, batch, DECODE_STEPS + 1)
    finally:
        moe.route = route
    launches = {n: fn.launches for n, fn in counters.items()}
    flash = counters["flash_attention"]
    routes = {"launches_tc": flash.launches_tc,
              "launches_ffma": flash.launches_ffma}
    peak = torch.cuda.max_memory_allocated(dev)
    if tally != {"prefill": n_attn, "decode": 0} or launches != {
            **{n: 0 for n in counters}, "flash_attention": n_attn} \
            or routes != {"launches_tc": n_attn, "launches_ffma": 0}:
        raise AssertionError(f"{arch} model path launches {tally} / "
                             f"{launches} / {routes}")
    if tuple(out.logits.shape) != (MODEL_BATCH, DECODE_STEPS + 1,
                                   cfg.vocab_size):
        raise AssertionError(f"logits shape {tuple(out.logits.shape)}")
    if not bool(torch.isfinite(out.logits).all()):
        raise AssertionError(f"non-finite logits on the {arch} path")
    row = {"phase": "model_path", "arch": arch, "layers": cfg.n_layers,
           "layer_pattern": list(cfg.layer_pattern),
           "attention_layers": n_attn,
           "params": param_count(params), "n_params_formula": cfg.n_params(),
           "param_dtype": cfg.param_dtype,
           "batch": MODEL_BATCH, "prompt_len": PROMPT_LEN,
           "decode_steps": DECODE_STEPS, "init_s": init_s,
           "prefill_s": out.prefill_s, "decode_s": out.decode_s,
           "decode_tokens_per_s": MODEL_BATCH * DECODE_STEPS / out.decode_s,
           "launches_prefill": tally["prefill"],
           "launches_decode": tally["decode"], "launches": launches,
           "flash_routes": routes, "logits_finite": True,
           "max_memory_allocated_gb": peak / 1e9,
           "tokens_head": out.tokens[0, :8].tolist(), "nvidia_smi": smi}
    if cfg.is_moe:
        n_prompt = MODEL_BATCH * PROMPT_LEN
        by_part = {"prefill": [r for r in routed if r[0] == n_prompt],
                   "decode": [r for r in routed if r[0] == MODEL_BATCH]}
        if len(by_part["prefill"]) != cfg.n_layers or len(
                by_part["decode"]) != cfg.n_layers * DECODE_STEPS or len(
                routed) != cfg.n_layers * (DECODE_STEPS + 1):
            raise AssertionError(f"MoE routings {len(routed)}")
        row.update({
            "moe_capacity": {k: sorted({c for _, c, _ in v})
                             for k, v in by_part.items()},
            "moe_dropped_choices": {k: int(sum(n for *_, n in v))
                                    for k, v in by_part.items()},
            "moe_choices": {k: len(v) * v[0][0] * cfg.top_k
                            for k, v in by_part.items()}})
    del out, routed

    # The first attention layer's prefill attention (its window too): the
    # kernel route the path took, against the plain chunked scan, which
    # also computes in fp32 and rounds once (ATTN_TOL's bf16 limit).
    x = params["embed"][torch.as_tensor(batch["tokens"], device=dev).long()]
    positions = torch.arange(PROMPT_LEN, device=dev)
    first = first_layer(params, cfg, ATTENTION_KINDS)
    if first is not None:
        kind, name, layer = first
        window = cfg.window if kind == "lattn" else None
        h = apply_norm(layer["norm1"], x, cfg.norm)
        q, k, v = qkv(layer["temporal"], h, cfg, positions)
        o_kernel = long_attention(q, k, v, True, window, cfg.attn_chunk)
        o_plain = chunked_attention(q, k, v, causal=True, window=window,
                                    chunk=cfg.attn_chunk)
        try:
            err = attn_err(o_kernel, o_plain)
        except AssertionError as e:
            raise AssertionError(f"{arch} {name} attention, kernel vs "
                                 f"chunked: {e}") from None
        row["attention_check"] = {"layer": name, "kind": kind,
                                  "window": window,
                                  "max_abs_err_vs_chunked": err}
        del q, k, v, o_kernel, o_plain
        if cfg.is_moe:
            t, _ = attention_prefill(layer["temporal"], h, cfg, positions)
            x2 = x + t.to(x.dtype)
            row.update(moe_layer_check(layer, apply_norm(layer["norm2"], x2,
                                                         cfg.norm), cfg))
            del t, x2
        del h
    del x
    for kind in ("rglru", "ssm"):
        found = first_layer(params, cfg, (kind,))
        if found is not None:
            row.setdefault("layer0_state_handoff", {})[kind] = \
                state_handoff(found, cfg, params["embed"])
            row.setdefault("recurrence_ms", {})[kind] = recurrence_times(
                found, cfg, params["embed"], batch["tokens"])
    torch.cuda.empty_cache()
    emit(row)
    return launches, bundle, params, batch


def recurrence_times(found, cfg, embed, tokens):
    """The first rglru or ssm layer's prefill over the prompt as the main
    path runs it (bf16 weights and activations): the recurrence alone
    (``linear_scan`` of its fp32 decays and inputs, or ``ssd_chunked``) and
    the whole temporal block with its cache (``rglru_prefill`` or
    ``_ssm_prefill``). CUDA events over back-to-back calls: where the host
    dispatches slower than the card runs, that is the host's time."""
    from repro_torch.models import rglru, ssm
    from repro_torch.models.layers import apply_norm, causal_depthwise_conv
    from repro_torch.models.transformer import _ssm_prefill

    kind, name, layer = found
    p = layer["temporal"]
    x = embed[torch.as_tensor(tokens, device=embed.device).long()]
    h = apply_norm(layer["norm1"], x, cfg.norm)
    if kind == "rglru":
        xc, _ = causal_depthwise_conv(h @ p["w_x"], p["conv_w"])
        log_a, b = rglru._gates(p, xc)
        a = torch.exp(log_a)
        scan, block = (lambda: rglru.linear_scan(a, b),
                       lambda: rglru.rglru_prefill(p, h, cfg))
    else:
        z, _, xs, bs, cs, dt, _ = ssm._in_proj(p, h, cfg)
        xh = xs.reshape(*xs.shape[:2], -1, cfg.ssm_head_dim)
        x_dt = xh * dt[..., None].to(xh.dtype)
        da = dt * -torch.exp(p["A_log"])
        scan, block = (lambda: ssm.ssd_chunked(x_dt, da, bs, cs,
                                               cfg.ssm_chunk),
                       lambda: _ssm_prefill(p, h, cfg))
    out = {"layer": name, "tokens": h.shape[1], "scan_ms": cuda_ms(scan, 5),
           "block_prefill_ms": cuda_ms(block, 5)}
    torch.cuda.empty_cache()
    return out


def state_handoff(found, cfg, embed):
    """The recurrent layer's prefill-to-decode handoff at full width, in
    fp32 (TF32 off): prefill P = 8192 tokens, then one decode step for
    token P+1 from the prompt's cache (restaged into fresh tensors, as
    ``generate`` does), against a prefill over all P+1 tokens: the step's
    output against that prefill's last row, and the cache the step wrote
    in place against that prefill's cache, each within
    :data:`HANDOFF_TOL` of its largest |value|. A wrong conv tail, a wrong
    prefill state or a cache not updated in place fails it."""
    from repro_torch.configs import demo_batch
    from repro_torch.models import rglru, ssm
    from repro_torch.models.layers import apply_norm
    from repro_torch.models.transformer import _ssm_prefill, tree_map

    kind, name, layer = found
    prefill, decode = {
        "rglru": (rglru.rglru_prefill, rglru.apply_rglru_decode),
        "ssm": (_ssm_prefill, ssm.apply_ssm_decode)}[kind]
    p = tree_map(lambda t: t.float(), layer["temporal"])
    tokens = demo_batch(cfg, "prefill", MODEL_BATCH, PROMPT_LEN + 1,
                        seed=1)["tokens"]
    x = embed[torch.as_tensor(tokens, device=embed.device).long()].float()
    h = apply_norm(tree_map(lambda t: t.float(), layer["norm1"]), x,
                   cfg.norm)
    want, want_cache = prefill(p, h, cfg)
    _, cache = prefill(p, h[:, :PROMPT_LEN], cfg)
    cache = {n: t.clone() for n, t in cache.items()}
    held = dict(cache)
    got, _ = decode(p, h[:, PROMPT_LEN:], cache, cfg)
    torch.cuda.synchronize()
    if any(cache[n] is not held[n] for n in held):
        raise AssertionError(f"{cfg.name} {name} ({kind}): decode rebound "
                             f"its cache")

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    errs = {"output": rel(got[:, 0], want[:, -1]),
            **{f"cache_{n}": rel(cache[n], want_cache[n]) for n in cache}}
    if not all(e <= HANDOFF_TOL for e in errs.values()) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"{cfg.name} {name} ({kind}) state handoff: "
                             f"{errs}")
    return {"layer": name, "prompt_len": PROMPT_LEN, "dtype": "float32",
            "max_rel_err": errs, "tol_share_of_max": HANDOFF_TOL}


def moe_layer_check(p, h2, cfg):
    """Layer 0's MoE FFN on the prompt's normed activations (bf16, one
    8192-token chunk): the main path (``apply_moe``: index dispatch and
    combine) against ``moe_chunk_plain`` (the reference's one-hot einsums)
    plus the shared experts. Equal top-k indices and keep masks, the
    dispatched (E, C, D) buffers bitwise equal, outputs within
    :data:`MOE_TOL`; then both versions' times for the routed part."""
    from repro_torch.models import moe
    from repro_torch.models.layers import apply_mlp

    xt = h2.reshape(-1, cfg.d_model)
    r = moe.route(p["ffn"]["router"], xt, cfg)
    out, aux = moe.apply_moe(p["ffn"], h2, cfg)
    out_p, aux_p, idx_p, keep_p, xin_p = moe.moe_chunk_plain(p["ffn"], xt,
                                                             cfg)
    if not (torch.equal(r.idx, idx_p) and torch.equal(r.keep, keep_p)):
        raise AssertionError("layer-0 MoE: main and plain route differently")
    if not torch.equal(moe.dispatch(xt, r), xin_p):
        raise AssertionError("layer-0 MoE: dispatched buffers differ")
    want = out_p.reshape(h2.shape) + apply_mlp(p["ffn"]["shared"], h2,
                                               cfg.act)
    del xin_p, out_p
    rtol, atol_share = MOE_TOL
    err = (out.float() - want.float()).abs()
    limit = atol_share * float(want.float().abs().max()) \
        + rtol * want.float().abs()
    if bool((err > limit).any()) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"layer-0 MoE: max abs err {float(err.max())}")
    aux_err = abs(float(aux) - float(aux_p))
    if aux_err > 1e-5:
        raise AssertionError(f"layer-0 MoE: aux differs by {aux_err}")
    main_ms = cuda_ms(lambda: moe.moe_chunk(p["ffn"], xt, cfg), 5)
    plain_ms = cuda_ms(lambda: moe.moe_chunk_plain(p["ffn"], xt, cfg), 2, 1)
    return {"layer0_moe": {
        "tokens": xt.shape[0], "capacity": r.capacity,
        "dropped_choices": int((~r.keep).sum()),
        "routing_equal": True, "dispatch_bitwise": True,
        "max_abs_err_vs_plain": float(err.max()),
        "max_abs_out": float(want.float().abs().max()),
        "rtol_atol_share": list(MOE_TOL), "aux": float(aux),
        "aux_abs_err": aux_err, "main_ms": main_ms, "plain_ms": plain_ms}}


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
        row = {"phase": "model_profile", "arch": bundle.cfg.name,
               "part": name,
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


def phase_moe_decode_floor(bundle, params):
    """What one MoE decode token must read: at capacity 1 every expert of
    every layer runs on its one-slot buffer, so the expert products read all
    expert weights, a bytes floor at the card's HBM rate. Measured: the
    expert products alone (``models.moe.experts`` over every layer on a
    (E, 1, D) buffer; CUDA events over back-to-back calls, each layer's 1.1
    GB far past the 50 MB L2)."""
    from repro_torch.models import moe
    from repro_torch.models.transformer import tree_map

    cfg = bundle.cfg
    blocks = params["stack"]["blocks"][0]["ffn"]
    n_bytes = sum(blocks[n].numel() * blocks[n].element_size()
                  for n in ("w_gate", "w_up", "w_down"))
    layers = [tree_map(lambda t: t[i], blocks) for i in range(cfg.n_layers)]
    g = torch.Generator(device=bundle.device).manual_seed(1)
    xin = torch.randn((cfg.n_experts, 1, cfg.d_model), generator=g,
                      device=bundle.device).to(blocks["w_up"].dtype)

    def all_layers():
        for p in layers:
            moe.experts(p, xin, cfg.act)

    ms = cuda_ms(all_layers, 5, 1)
    floor_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    emit({"phase": "model_profile", "arch": cfg.name,
          "part": "moe_decode_floor",
          "expert_bytes_per_token": n_bytes,
          "expert_bytes_per_layer": n_bytes / cfg.n_layers,
          "floor_ms_per_token": floor_ms,
          "experts_ms_per_token": ms,
          "experts_gb_per_s": n_bytes / ms / 1e6,
          "floor_share": floor_ms / ms})


def phase_model_parity(dev):
    """The port on the card against the port on the host at reduced
    glm4-9b, deepseek-moe-16b, llama4-scout-17b-a16e, mamba2-370m and
    recurrentgemma-2b in fp32, the same weights on both (the MoE models
    with ``moe_chunk`` 16, so their chunk loop and its zero-padded tail
    run; recurrentgemma at 8 layers, so its two trailing layers run):
    prompts of 33 (plain attention; not a multiple of the SSD chunk 16) and
    160 tokens (> attn_chunk = 64: the FFMA kernel on the card, window 32
    for recurrentgemma's local attention; the chunked scan on the host), 8
    decode steps; logits within 1e-4 of the host's largest, greedy tokens
    equal; one FFMA launch per attention layer at 160."""
    import dataclasses

    from repro_torch.configs import demo_batch, get_config
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    from repro_torch.models.transformer import tree_map

    for arch in (MODEL_ARCH, MOE_ARCH, "llama4-scout-17b-a16e",
                 "mamba2-370m", "recurrentgemma-2b"):
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  param_dtype="float32")
        if cfg.is_moe:
            cfg = dataclasses.replace(cfg, moe_chunk=16)
        if arch == "recurrentgemma-2b":
            cfg = dataclasses.replace(cfg, n_layers=8)
        host = build_model(cfg, device="cpu")
        card = build_model(cfg, device=dev)
        p_host = host.init(torch.Generator().manual_seed(0))
        p_card = tree_map(lambda t: t.to(dev), p_host)
        rels = {}
        ffma0, tc0 = (flash_attention_cuda.launches_ffma,
                      flash_attention_cuda.launches_tc)
        for prompt in (33, 160):
            batch = demo_batch(cfg, "prefill", 2, prompt, seed=prompt)
            a = generate(host, p_host, batch, 9)
            b = generate(card, p_card, batch, 9)
            rel = float((b.logits.cpu() - a.logits).abs().max()
                        / a.logits.abs().max())
            if rel > 1e-4 or not torch.equal(a.tokens, b.tokens.cpu()):
                raise AssertionError(
                    f"{arch}: card != host at prompt {prompt}: rel {rel}")
            rels[prompt] = rel
        routes = {"launches_ffma": flash_attention_cuda.launches_ffma - ffma0,
                  "launches_tc": flash_attention_cuda.launches_tc - tc0}
        n_attn = attention_layer_count(cfg)
        if routes != {"launches_ffma": n_attn, "launches_tc": 0}:
            raise AssertionError(f"{arch}: fp32 model path flash routes "
                                 f"{routes}")
        emit({"phase": "model_parity", "arch": cfg.name + " (reduced, fp32)",
              "layers": cfg.n_layers, "attention_layers": n_attn,
              "prompts": [33, 160], "decode_steps": 8,
              **({"moe_chunk": cfg.moe_chunk} if cfg.is_moe else {}),
              "max_rel_logit_err": rels, "greedy_tokens_equal": True,
              "flash_routes": routes})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.tile_checksum import tile_checksum_cuda
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
    from repro_torch.kernels.tile_checksum import DYNAMIC_SMEM

    emit({"phase": "build", "seconds": build_s,
          "libraries": sorted(p.name for p in paths.values()),
          "ptxas": ptxas,
          "tile_checksum": {"ptxas": ptxas_report(paths["tile_checksum"]),
                            "dynamic_smem": DYNAMIC_SMEM}})

    # ---- 3. kernels vs their plain versions ----
    dev = torch.device("cuda", 0)
    kernels = phase_kernels(dev)
    # Timed here, before any Sec. V or model run: later in the process the
    # profiler's trace of a few calls loses kernel records.
    kernels["flash_attention"] = phase_flash(dev, paths)

    # ---- 4. main path: Sec. V power iteration ----
    phase_parity()
    counters = {"usec_matvec": usec_matvec_cuda,
                "usec_segmented": usec_segmented_cuda,
                "flash_attention": flash_attention_cuda,
                "tile_checksum": tile_checksum_cuda}
    totals, mains = phase_main_path(counters)
    for n in ("usec_matvec", "usec_segmented"):
        if totals[n] <= 0:
            raise AssertionError(f"{n} never launched on the main path")
    if totals["flash_attention"] != 0:
        raise AssertionError("flash_attention launched on the Sec. V path")
    phase_profile()

    # ---- 4b. the engine's other step paths at Sec. V ----
    elastic = phase_elastic_modes(counters, mains, smi)
    for n in ("usec_matvec", "usec_segmented"):
        if elastic[n] <= 0:
            raise AssertionError(f"{n} never launched by elastic_modes")
        totals[n] += elastic[n]
    phase_elastic_profile(smi)

    # ---- 5. main path: the model stack's serving path (glm4-9b,
    # deepseek-moe-16b, recurrentgemma-2b, mamba2-370m; each drops its
    # weights before the next) ----
    totals["flash_attention"] = 0
    for arch in MODEL_ARCHS:
        model_launches, bundle, params, batch = phase_model_path(
            dev, counters, smi, arch)
        totals["flash_attention"] += model_launches["flash_attention"]
        phase_model_profile(bundle, params, batch)
        if bundle.cfg.is_moe:
            phase_moe_decode_floor(bundle, params)
        del bundle, params, batch
        gc.collect()
        torch.cuda.empty_cache()
    phase_model_parity(dev)

    # ---- 6. checkpoint / resume and the serving path at Sec. V ----
    phase_checkpoint(smi)
    served = phase_serve_path(counters, smi)
    for n in ("usec_matvec", "usec_segmented"):
        if served[n] <= 0:
            raise AssertionError(f"{n} never launched by serve_path")
        totals[n] += served[n]

    # ---- 7. faults + integrity at Sec. V ----
    # Last: the runs with the integrity checker on make the profiler's
    # trace lose kernel records for the rest of the process (gc and
    # empty_cache do not bring them back), so every profiled phase runs
    # before it.
    faulted = phase_elastic_faults(counters, smi,
                                   kernels["tile_checksum"]["ms"])
    for n in ("usec_matvec", "usec_segmented", "tile_checksum"):
        if faulted[n] <= 0:
            raise AssertionError(f"{n} never launched by elastic_faults")
        totals[n] = totals.get(n, 0) + faulted[n]

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
