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
FFMA kernel, causal and bidirectional; one full-width glm4-9b layer, one
deepseek-moe-16b layer, one recurrentgemma-2b windowed layer, one
hubert-xlarge bidirectional layer and one internvl2-2b layer),
then drives the paper's Sec. V experiment through the normal front door,
``ElasticEngine(MatVecPowerIteration, backend="device")``: N = 6 workers,
J = 3, a 6000 x 6000 integer-valued matrix, cyclic and MAN placements at
S in {0, 1}, scripted churn, 8 steps, ``verify="exact"`` at every step, in
both executor modes (per-block ``usec_matvec`` and one ``usec_segmented``
launch a step). Then the model stack's serving path: glm4-9b,
deepseek-moe-16b (64 routed experts, top-6), recurrentgemma-2b (RG-LRU +
local attention), mamba2-370m (Mamba-2 SSD) and internvl2-2b (a VLM: 1024
patch embeddings prefix 7168 tokens) in turn at full width and depth with
random weights through ``repro_torch.launch.serve.generate`` (an
8192-position prompt, 32 greedy decode steps; one kernel launch per
prefill attention layer, none in decode; the first attention layer and
layer 0's MoE FFN against their plain versions; the first rglru and ssm
layer's prefill-to-decode state handoff in fp32), and the hubert-xlarge
encoder's one forward over 8192 audio frames (48 bidirectional launches),
a profiled prefill + decode each decoder, the MoE decode's expert-read
floor, and card-vs-host parity at reduced size (glm4-9b, both MoE models,
both recurrent models, internvl2-2b and hubert-xlarge). Then training:
``train_path`` takes 3 steps of internvl2-2b at full width and depth
through ``repro_torch.launch.train.main`` (4 workers, S = 1, a worker
dropped a step, 8192 positions a tile, so the flash kernel runs under
autograd: exact launch counts, the last step profiled),
``train_drop_exact`` holds the step's loss to 1e-5 with each worker
dropped, ``train_flash_grad`` holds the kernel route's gradients to the
plain scan's at one layer's shape, ``train_parity`` holds one usec
step on the card to the host's for three reduced archs, ``train_remat``
holds the reference's three remat policies bitwise to each other (time
and peak memory each), ``dryrun`` holds ``repro_torch.launch.dryrun``
against the card (its H100 memory constant; one production cell per train
mode at 256 fake ranks, each ``ok``; the trainer's cell and glm4-9b's
8192-token prefill dry-run at world 1 and run for real: the predicted
peak within 5 % of ``max_memory_allocated``, the predicted flops equal to
``FlopCounterMode``'s), and ``train_dist`` runs 4 ranks of the usec step
(with four cards: NCCL, the trainer at full depth under
torch.distributed.run, held to train_path's losses; with one card: 4 gloo
ranks sharing it at DIST_DEPTH layers, fp32 and compressed, held to the
one-process step; a one-rank NCCL group issues every collective);
``train_tp`` splits glm4-9b at 1 layer over 2 model shards and
``train_fsdp`` cuts its parameters and moments over 2 data ranks (the
sharded fsdp step) and the usec step's moments by ZeRO-1, each held to its
unsharded step; ``train_sp`` runs that fsdp step over 2 model shards with
the sequence-parallel residual stream and without it, held to each other
and to the dry-run's bytes and peak; ``serve_tp`` serves glm4-9b (2 layers
bf16, 1 layer fp32)
and recurrentgemma-2b (3 layers) at full width over 2 model shards (the
weights and the decode caches cut by the reference's rules; an 8192-token
prompt and 16 decode steps), held to the one-process run. Then
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
    for ev in device_rows(prof):
        us = getattr(ev, "self_device_time_total", 0) or 0
        if us > 0:
            out[ev.key] = (float(us), int(ev.count))
    return out


def device_rows(prof):
    """The device entries of ``prof.key_averages()``: kernels, copies and
    sets. A CPU op's row is left out, since its device time is its kernels'
    time again, and so is a host range's device-side annotation (the
    program's spans under a profiler), which spans its kernels and the idle
    gaps between them."""
    return [ev for ev in prof.key_averages()
            if str(ev.device_type).endswith("CUDA")
            and not getattr(ev, "is_user_annotation", False)]


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
        for ev in device_rows(prof))


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
          int(e.count)) for e in device_rows(prof)), reverse=True)
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
        entries = sorted(
            ((float(getattr(e, "self_device_time_total", 0) or 0), e.key,
              int(e.count)) for e in device_rows(prof)), reverse=True)
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
MODEL_ARCHS = (MODEL_ARCH, MOE_ARCH, "recurrentgemma-2b", "mamba2-370m",
               "internvl2-2b")
# The encoder: one forward over 8192 audio frames (no decode).
ENCODER_ARCH = "hubert-xlarge"
# The trainer's cell: internvl2-2b at full width and depth, N = 4 workers,
# cyclic J = 2 over 4 tiles of one 8192-position sample (1024 patches + 7168
# tokens: above attn_chunk = 4096, so the flash kernel runs under autograd),
# S = 1, one worker dropped a step, 3 steps.
TRAIN_ARCH, TRAIN_STEPS, TRAIN_SEQ = "internvl2-2b", 3, 8192
TRAIN_ARGS = ["--arch", TRAIN_ARCH, "--workers", "4", "--replication", "2",
              "--straggler-tolerance", "1", "--drop-stragglers", "1",
              "--tiles-per-worker", "1", "--tile-samples", "1",
              "--seq-len", str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS),
              "--log-every", "1"]
# train_drop_exact's sequence: the same plan and model, 2048 positions
# (512 patches + 1536 tokens) so the five steps stay short.
DROP_SEQ = 2048
# (share of the largest |value|) of the gradient norm with one worker
# dropped against none: each worker's bf16 sum (internvl2-2b accumulates in
# bf16) rounds at most three times (each tile's weighted gradient, the adds)
# and a drop hands tiles to other workers' sums, so per element the two
# totals may differ by 6 roundings of 2^-9: 6 x 2^-9 = 1.2e-2.
DROP_GNORM_TOL = 6 * 2 ** -9
# The exact parameter count of the reference's init of each (its
# ``jax.eval_shape``; ``cfg.n_params()`` is an analytic approximation that
# misses the RG-LRU gates and the SSD norm). tests/test_torch_models.py
# holds this table to the reference.
EXACT_PARAMS = {"glm4-9b": 9399767040, "deepseek-moe-16b": 16879568896,
                "recurrentgemma-2b": 2894528000, "mamba2-370m": 368227840,
                "hubert-xlarge": 945912320, "internvl2-2b": 1891244032}
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
# tests/test_kernels.py's seven cases, then the local heads of one glm4-9b
# layer at the prompt length over 2 and over 4 model shards (train_tp, the
# four-card trainer): (b, h, hk, sq, skv, d, causal, window, dtype).
FLASH_CASES = [
    (1, 2, 2, 128, 128, 64, True, None, torch.float32),
    (2, 4, 2, 100, 260, 64, True, None, torch.float32),
    (1, 2, 1, 64, 300, 32, False, None, torch.float32),
    (1, 2, 2, 256, 256, 64, True, 128, torch.float32),
    (1, 4, 4, 1, 384, 64, True, None, torch.float32),
    (1, 2, 2, 200, 200, 128, True, 64, torch.float32),
    (1, 2, 2, 128, 128, 64, True, None, torch.bfloat16),
    (1, 16, 1, PROMPT_LEN, PROMPT_LEN, 128, True, None, torch.bfloat16),
    (1, 8, 1, PROMPT_LEN, PROMPT_LEN, 128, True, None, torch.bfloat16),
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
     (1, 8, 2, 1000, 1130, 128, True, None, torch.bfloat16),
     # Bidirectional (the encoder's): sq != skv either way, skv not a
     # multiple of the KV tile, MHA and GQA, d 80 (two 64-column panels,
     # the second a quarter live) and 128; fp32 at d 80.
     (1, 16, 16, 300, 333, 80, False, None, torch.bfloat16),
     (2, 8, 2, 333, 150, 80, False, None, torch.bfloat16),
     (1, 16, 8, 200, 333, 128, False, None, torch.bfloat16),
     (1, 4, 4, 1000, 1130, 128, False, None, torch.bfloat16),
     (1, 4, 2, 200, 333, 80, False, None, torch.float32)]
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
# One hubert-xlarge encoder layer (MHA 16 x 80, bidirectional) and one
# internvl2-2b layer (GQA 16:8 x 128, causal) at 8192 positions.
FLASH_LAYER_HUBERT = (1, 16, 16, PROMPT_LEN, PROMPT_LEN, 80, False, None,
                      torch.bfloat16)
FLASH_LAYER_INTERNVL2 = (1, 16, 8, PROMPT_LEN, PROMPT_LEN, 128, True, None,
                         torch.bfloat16)
# One glm4-9b layer's local heads over 4 model shards: 32 / 4 query heads,
# and the one KV head they read (2 x 128 KV columns over 4 is half a head
# a shard, gathered whole).
FLASH_LAYER_TP4 = FLASH_CASES[-1]
# The local heads of one qwen1.5-110b layer (64 query and 8 KV heads) and
# one llama4-scout-17b-a16e layer (40 and 8) over 2 model shards: the
# four-card sharded fsdp step (train_dist_probe.py --fsdp-only).
FLASH_LAYER_QWEN_M2 = (1, 32, 4, PROMPT_LEN, PROMPT_LEN, 128, True, None,
                       torch.bfloat16)
FLASH_LAYER_SCOUT_M2 = (1, 20, 4, PROMPT_LEN, PROMPT_LEN, 128, True, None,
                        torch.bfloat16)
# The same layers' local heads over 4 model shards: the four-card serving
# cells (train_dist_probe.py --serve-only).
FLASH_LAYER_QWEN_M4 = (1, 16, 2, PROMPT_LEN, PROMPT_LEN, 128, True, None,
                       torch.bfloat16)
FLASH_LAYER_SCOUT_M4 = (1, 10, 2, PROMPT_LEN, PROMPT_LEN, 128, True, None,
                        torch.bfloat16)
# The serve_tp phase's local heads over 2 model shards: a recurrentgemma-2b
# local-attention layer's (10 query heads over 2, the window kept).
FLASH_LAYER_WINDOW_M2 = (1, 5, 1, PROMPT_LEN, PROMPT_LEN, 256, True, 2048,
                         torch.bfloat16)
# The fp32 (FFMA kernel) shapes of the serve_tp phase's glm4-9b fp32 cell:
# one card's layer and its local heads over 2 model shards.
FLASH_SERVE_FP32 = [(1, 32, 2, PROMPT_LEN, PROMPT_LEN, 128, True, None,
                     torch.float32),
                    (1, 16, 1, PROMPT_LEN, PROMPT_LEN, 128, True, None,
                     torch.float32)]
# The train_sp phase's flash shape: a microbatch of 2 rows on glm4-9b's
# local heads over 2 model shards (checked, not timed).
FLASH_TRAIN_SP = (2, 16, 1, PROMPT_LEN, PROMPT_LEN, 128, True, None,
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
        live_pairs,
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
    layer (MHA), one recurrentgemma-2b local-attention layer (d 256, GQA
    10, window 2048), one hubert-xlarge encoder layer (bidirectional, MHA,
    d 80), one internvl2-2b layer (GQA 2, d 128), a glm4-9b layer's
    local heads over 4 model shards (GQA 8:1), a qwen1.5-110b and a
    llama4-scout-17b-a16e layer's over 2 (GQA 8:1, 5:1) and over 4 (GQA
    8:1, 5:1) and a recurrentgemma-2b local-attention layer's over 2 (GQA
    5:1, window 2048); each layer's times:
    kernel, plain version, and one library
    call (SDPA) as a yardstick; the fp32 glm4-9b layer, whole and over 2
    model shards, and train_sp's two-row microbatch on glm4-9b's local
    heads over 2, against the plain version only; and both kernels' ptxas
    registers and spills. The kernels line takes the glm4-9b layer's
    numbers."""
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
    hubert = flash_layer(FLASH_LAYER_HUBERT, dev, 96)
    internvl2 = flash_layer(FLASH_LAYER_INTERNVL2, dev, 95)
    tp4 = flash_layer(FLASH_LAYER_TP4, dev, 94)
    qwen_m2 = flash_layer(FLASH_LAYER_QWEN_M2, dev, 93)
    scout_m2 = flash_layer(FLASH_LAYER_SCOUT_M2, dev, 92)
    qwen_m4 = flash_layer(FLASH_LAYER_QWEN_M4, dev, 91)
    scout_m4 = flash_layer(FLASH_LAYER_SCOUT_M4, dev, 90)
    windowed_m2 = flash_layer(FLASH_LAYER_WINDOW_M2, dev, 89)
    serve_fp32 = [{"shape": list(c[:8]), "max_abs_err": flash_check(c, dev, 88)}
                  for c in FLASH_SERVE_FP32]
    train_sp = {"shape": list(FLASH_TRAIN_SP[:8]),
                "max_abs_err": flash_check(FLASH_TRAIN_SP, dev, 87)}
    torch.cuda.empty_cache()
    routes = {"launches_tc": flash_attention_cuda.launches_tc - routes0[0],
              "launches_ffma": flash_attention_cuda.launches_ffma - routes0[1]}
    emit({"phase": "kernel", "name": "flash_attention",
          "cases": len(cases) + 12 + len(FLASH_SERVE_FP32),
          "max_abs_err_cases": errs,
          "rtol_atol": {str(dt).replace("torch.", ""): tol
                        for dt, tol in ATTN_TOL.items()},
          "bitwise_run_to_run": True, "dtype": "bfloat16",
          "layer_glm4_9b": layer, "layer_deepseek_moe_16b_mha": mha,
          "layer_recurrentgemma_2b_lattn": windowed,
          "layer_hubert_xlarge_bidirectional": hubert,
          "layer_internvl2_2b": internvl2,
          "layer_glm4_9b_over_4_model_shards": tp4,
          "layer_qwen1_5_110b_over_2_model_shards": qwen_m2,
          "layer_llama4_scout_over_2_model_shards": scout_m2,
          "layer_qwen1_5_110b_over_4_model_shards": qwen_m4,
          "layer_llama4_scout_over_4_model_shards": scout_m4,
          "layer_recurrentgemma_2b_lattn_over_2_model_shards": windowed_m2,
          "layer_glm4_9b_fp32_whole_and_over_2_model_shards": serve_fp32,
          "layer_glm4_9b_train_sp_local_heads_two_rows": train_sp,
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


def _causal_spy(seen):
    """Wrap ``kernels.ops.flash_attention`` (the model's route to the flash
    kernel) so that each call's ``causal`` lands in ``seen``; returns the
    function that undoes it."""
    from repro_torch.kernels import ops

    real = ops.flash_attention

    def spy(*args, **kwargs):
        seen.append(bool(kwargs.get("causal", True)))
        return real(*args, **kwargs)

    ops.flash_attention = spy
    return lambda: setattr(ops, "flash_attention", real)


def phase_model_path(dev, counters, smi, arch):
    """``arch`` at full width and depth: weights from a seed and an
    8192-position prompt. A decoder goes through
    ``repro_torch.launch.serve.generate`` (restage, 32 greedy decode steps;
    internvl2-2b's prompt is 1024 patches + 7168 tokens); the encoder
    (hubert-xlarge) through one ``bundle.prefill``, its forward over 8192
    frames. The parameter count is the reference init's exact count
    (:data:`EXACT_PARAMS`). Every attention layer of the prefill launches
    the flash kernel once, on the tensor-core route (bf16), causal in a
    decoder and bidirectional in the encoder; recurrent layers and decode
    never do. Then the first attention layer's prefill attention (with its
    window), kernel route against the plain ``chunked_attention``; for an
    MoE model layer 0's MoE FFN against its plain version
    (:func:`moe_layer_check`); for a recurrent model its first rglru or ssm
    layer's state handoff (:func:`state_handoff`). Returns the main path's
    launch counts and what the profile phase reuses."""
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

    causal_seen = []
    reset_launches(counters)
    moe.route = logged_route
    undo_spy = _causal_spy(causal_seen)
    try:
        if cfg.decoder:
            out = generate(counted, params, batch, DECODE_STEPS + 1)
            logits, steps = out.logits, DECODE_STEPS + 1
        else:
            t0 = time.perf_counter()
            with torch.no_grad():
                _, logits = counted.prefill(params, batch)
            torch.cuda.synchronize()
            encode_s, steps = time.perf_counter() - t0, None
    finally:
        moe.route = route
        undo_spy()
    launches = {n: fn.launches for n, fn in counters.items()}
    flash = counters["flash_attention"]
    routes = {"launches_tc": flash.launches_tc,
              "launches_ffma": flash.launches_ffma}
    peak = torch.cuda.max_memory_allocated(dev)
    if tally != {"prefill": n_attn, "decode": 0} or launches != {
            **{n: 0 for n in counters}, "flash_attention": n_attn} \
            or routes != {"launches_tc": n_attn, "launches_ffma": 0} \
            or causal_seen != [cfg.decoder] * n_attn:
        raise AssertionError(f"{arch} model path launches {tally} / "
                             f"{launches} / {routes} / causal {causal_seen}")
    want_shape = ((MODEL_BATCH, steps, cfg.vocab_size) if steps
                  else (MODEL_BATCH, cfg.vocab_size))
    if tuple(logits.shape) != want_shape:
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"non-finite logits on the {arch} path")
    row = {"phase": "model_path", "arch": arch, "layers": cfg.n_layers,
           "layer_pattern": list(cfg.layer_pattern),
           "attention_layers": n_attn, "causal": cfg.decoder,
           "params": param_count(params), "n_params_formula": cfg.n_params(),
           "param_dtype": cfg.param_dtype,
           "batch": MODEL_BATCH, "prompt_len": PROMPT_LEN,
           "prompt": {k: list(np.shape(v)) for k, v in batch.items()},
           "init_s": init_s, "launches_prefill": tally["prefill"],
           "launches_decode": tally["decode"], "launches": launches,
           "flash_routes": routes, "flash_causal": sorted(set(causal_seen)),
           "logits_finite": True,
           "max_memory_allocated_gb": peak / 1e9, "nvidia_smi": smi}
    if cfg.decoder:
        row.update({"decode_steps": DECODE_STEPS, "prefill_s": out.prefill_s,
                    "decode_s": out.decode_s,
                    "decode_tokens_per_s": MODEL_BATCH * DECODE_STEPS
                    / out.decode_s,
                    "tokens_head": out.tokens[0, :8].tolist()})
    else:
        row.update({"encode_s": encode_s,
                    "frames_per_s": MODEL_BATCH * PROMPT_LEN / encode_s})
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
    del logits, routed
    if cfg.decoder:
        del out

    # The first attention layer's prefill attention (its window too): the
    # kernel route the path took, against the plain chunked scan, which
    # also computes in fp32 and rounds once (ATTN_TOL's bf16 limit).
    with torch.no_grad():
        x, _ = bundle.embed_batch(params, batch)
    positions = torch.arange(PROMPT_LEN, device=dev)
    first = first_layer(params, cfg, ATTENTION_KINDS)
    if first is not None:
        kind, name, layer = first
        window = cfg.window if kind == "lattn" else None
        h = apply_norm(layer["norm1"], x, cfg.norm)
        q, k, v = qkv(layer["temporal"], h, cfg, positions)
        o_kernel = long_attention(q, k, v, cfg.decoder, window,
                                  cfg.attn_chunk)
        o_plain = chunked_attention(q, k, v, causal=cfg.decoder,
                                    window=window, chunk=cfg.attn_chunk)
        try:
            err = attn_err(o_kernel, o_plain)
        except AssertionError as e:
            raise AssertionError(f"{arch} {name} attention, kernel vs "
                                 f"chunked: {e}") from None
        row["attention_check"] = {"layer": name, "kind": kind,
                                  "window": window, "causal": cfg.decoder,
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
    try:
        err = _within(out, want, MOE_TOL)
    except AssertionError as e:
        raise AssertionError(f"layer-0 MoE: {e}") from None
    aux_err = abs(float(aux) - float(aux_p))
    if aux_err > 1e-5:
        raise AssertionError(f"layer-0 MoE: aux differs by {aux_err}")
    main_ms = cuda_ms(lambda: moe.moe_chunk(p["ffn"], xt, cfg), 5)
    plain_ms = cuda_ms(lambda: moe.moe_chunk_plain(p["ffn"], xt, cfg), 2, 1)
    return {"layer0_moe": {
        "tokens": xt.shape[0], "capacity": r.capacity,
        "dropped_choices": int((~r.keep).sum()),
        "routing_equal": True, "dispatch_bitwise": True,
        "max_abs_err_vs_plain": err,
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
    glm4-9b, deepseek-moe-16b, llama4-scout-17b-a16e, mamba2-370m,
    recurrentgemma-2b, internvl2-2b (16 patches + text) and hubert-xlarge
    (the encoder: its forward's logits, no decode) in fp32, the same
    weights on both (the MoE models
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
                 "mamba2-370m", "recurrentgemma-2b", "internvl2-2b",
                 ENCODER_ARCH):
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
            if cfg.decoder:
                a = generate(host, p_host, batch, 9)
                b = generate(card, p_card, batch, 9)
                same = torch.equal(a.tokens, b.tokens.cpu())
                a, b = a.logits, b.logits
            else:  # the encoder: its one forward's last-frame logits
                with torch.no_grad():
                    a = host.prefill(p_host, batch)[1]
                    b = card.prefill(p_card, batch)[1]
                same = True
            rel = float((b.cpu() - a).abs().max() / a.abs().max())
            if rel > 1e-4 or not same:
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
              "prompts": [33, 160], "decode_steps": 8 if cfg.decoder else 0,
              **({"moe_chunk": cfg.moe_chunk} if cfg.is_moe else {}),
              "max_rel_logit_err": rels, "greedy_tokens_equal": True,
              "flash_routes": routes})


# (rtol, atol as a share of the largest |value|) of the training attention
# on the kernel route (FlashAttentionFn) against autograd through the plain
# chunked scan, in bf16: the forwards differ by one bf16 rounding (ATTN_TOL)
# and both backwards are the same fp32 recompute of the scan, summed in
# another order and rounded once to bf16; 1e-2 is ~2.5 bf16 ulps.
GRAD_TOL = (1e-2, 1e-2)
TRAIN_PARITY_ARCHS = ("stablelm-1.6b", "internvl2-2b", ENCODER_ARCH)


def _within(got, want, tol):
    """Max abs error of ``got`` against ``want``; raises past ``tol`` =
    (rtol, atol as a share of the largest |want|)."""
    rtol, share = tol
    err = (got.float() - want.float()).abs()
    limit = share * float(want.float().abs().max()) + rtol * want.float().abs()
    if bool((err > limit).any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"max abs err {float(err.max())} of max "
                             f"{float(want.float().abs().max())}")
    return float(err.max())


def phase_train_path(dev, counters, smi):
    """internvl2-2b at full width and depth through
    ``repro_torch.launch.train.main`` (:data:`TRAIN_ARGS`: 4 workers, J = 2,
    S = 1, one worker dropped a step, 8192 positions a tile, 3 steps): the
    pipeline, the scheduler, the usec step on the card (bf16 weights, bf16
    accumulation per worker, an fp32 sum, AdamW). Hard checks: a finite
    loss every step; the flash kernel launched exactly ``2 x 24`` times per
    micro-step (each of the 24 layers' forward, run again by the block's
    remat in the backward; ``FlashAttentionFn``'s backward recomputes the
    plain scan and launches nothing), all on the tensor-core route, no
    other kernel. Records each step's wall (synchronized), tokens/s, the
    peak memory and the device's busy share over the last step, which runs
    under torch.profiler (device activity only)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train
    from repro_torch.runtime import executor, trainstep

    trips, walls, metrics, busy = [], [], [], {}
    real_bp, real_make = executor.block_plan, trainstep.make_usec_train_step

    def bp_spy(*args, **kwargs):
        bp = real_bp(*args, **kwargs)
        trips.append(int(bp.n_blocks.sum()))
        return bp

    def make_spy(*args, **kwargs):
        step = real_make(*args, **kwargs)

        def timed_step(*step_args):
            last = len(walls) == TRAIN_STEPS - 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if last:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    out = step(*step_args)
                    torch.cuda.synchronize()
            else:
                out = step(*step_args)
                torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if last:
                busy["device_ms"] = _device_busy_ms(prof)
                busy["top_device"] = [
                    [e.key[:60], e.self_device_time_total / 1e3, e.count]
                    for e in sorted(prof.key_averages(), key=lambda e:
                                    -e.self_device_time_total)[:8]]
                del prof
            metrics.append({k: float(v) for k, v in out[3].items()})
            return out
        return timed_step

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(counters)
    executor.block_plan, trainstep.make_usec_train_step = bp_spy, make_spy
    try:
        loss = train.main(TRAIN_ARGS)
    finally:
        executor.block_plan, trainstep.make_usec_train_step = (real_bp,
                                                               real_make)
    launches = {n: fn.launches for n, fn in counters.items()}
    flash = counters["flash_attention"]
    peak = torch.cuda.max_memory_allocated(dev)
    from repro_torch.configs import get_config

    n_attn = attention_layer_count(get_config(TRAIN_ARCH))
    want = 2 * n_attn * sum(trips)
    if len(metrics) != TRAIN_STEPS or not all(
            np.isfinite(m["loss"]) for m in metrics) or loss != metrics[-1][
            "loss"]:
        raise AssertionError(f"train_path losses {metrics} / {loss}")
    if launches != {**{n: 0 for n in counters}, "flash_attention": want} \
            or flash.launches_tc != want or flash.launches_ffma != 0:
        raise AssertionError(f"train_path launches {launches}, tc "
                             f"{flash.launches_tc}, want {want}")
    computed = [t * TRAIN_SEQ for t in trips]
    emit({"phase": "train_path", "arch": TRAIN_ARCH, "args": TRAIN_ARGS,
          "steps": TRAIN_STEPS, "micro_steps": trips,
          "losses": [m["loss"] for m in metrics],
          "grad_norms": [m["grad_norm"] for m in metrics],
          "trained_tokens": [m["n_tokens"] for m in metrics],
          "step_wall_s": walls, "profiled_step": TRAIN_STEPS - 1,
          "computed_tokens_per_s": [c / w for c, w in zip(computed, walls)],
          "trained_tokens_per_s": [m["n_tokens"] / w
                                   for m, w in zip(metrics, walls)],
          "flash_launches": want, "flash_per_micro_step": 2 * n_attn,
          "launches": launches, "max_memory_allocated_gb": peak / 1e9,
          "profiled_device_ms": busy["device_ms"],
          "profiled_device_busy_share": busy["device_ms"] / 1e3 / walls[-1],
          "profiled_top_device": busy["top_device"], "nvidia_smi": smi})
    gc.collect()
    torch.cuda.empty_cache()
    return launches, metrics


def phase_train_drop_exact(dev, smi):
    """At full width (internvl2-2b, bf16), one S = 1 plan over the train
    cell's placement and one staged step of :data:`DROP_SEQ` positions: the
    usec step with no worker dropped, then with each single worker dropped
    (the redundant copies take over; tests/test_distributed.py's
    ``test_usec_train_straggler_drop_keeps_loss_exact``). The loss within
    1e-5 relative (fp32 sums in another order); the gradient norm within
    :data:`DROP_GNORM_TOL` (per-worker bf16 sums over other tiles)."""
    from repro_torch.configs import get_config
    from repro_torch.core import compile_plan, cyclic_placement, solve_assignment
    from repro_torch.data import TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime.executor import block_plan
    from repro_torch.runtime.trainstep import make_usec_train_step

    cfg = get_config(TRAIN_ARCH)
    bundle = build_model(cfg, device=dev)
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    opt = adamw.init(params)
    n = 4
    place = cyclic_placement(n, n, 2)
    pipe = TokenPipeline(cfg, place, seq_len=DROP_SEQ, tile_samples=1,
                         seed=0)
    plan = compile_plan(place, solve_assignment(place, np.ones(n),
                                                stragglers=1),
                        rows_per_tile=1, stragglers=1)
    b_max = int(plan.n_valid.max()) + 1
    step = make_usec_train_step(bundle, pipe.t_stage, b_max)
    sb = pipe.staged_for_step(0)
    runs = []
    for bad in [(), (0,), (1,), (2,), (3,)]:
        bp = block_plan(plan, sb.slot_of, 1, stragglers=bad, b_max=b_max)
        t0 = time.perf_counter()
        _, _, _, m = step(params, opt, None, sb.arrays, bp.blk_slot,
                          bp.blk_include, bp.n_blocks[:, None], 0.0)
        runs.append({"dropped": list(bad), "loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "n_tokens": float(m["n_tokens"]),
                     "micro_steps": int(bp.n_blocks.sum()),
                     "wall_s": time.perf_counter() - t0})
        del m
        gc.collect()
    base = runs[0]
    loss_err = max(abs(r["loss"] - base["loss"]) / abs(base["loss"])
                   for r in runs)
    gnorm_err = max(abs(r["grad_norm"] - base["grad_norm"])
                    / base["grad_norm"] for r in runs)
    if loss_err > 1e-5 or gnorm_err > DROP_GNORM_TOL or not all(
            np.isfinite(r["loss"]) and r["n_tokens"] == base["n_tokens"]
            for r in runs):
        raise AssertionError(f"train_drop_exact: {runs}")
    emit({"phase": "train_drop_exact", "arch": TRAIN_ARCH,
          "seq_len": DROP_SEQ, "workers": n, "runs": runs,
          "max_rel_loss_err": loss_err, "max_rel_grad_norm_err": gnorm_err,
          "tol": {"loss": 1e-5, "grad_norm": DROP_GNORM_TOL},
          "nvidia_smi": smi})
    del bundle, params, opt, step
    gc.collect()
    torch.cuda.empty_cache()


def phase_train_flash_grad(dev):
    """One internvl2-2b layer's training attention at 8192 positions in
    bf16 (GQA 16:8 x 128, causal, attn_chunk 4096): (a) on q, k, v,
    ``FlashAttentionFn`` (the kernel forward, the recomputed scan's
    backward) against autograd through ``chunked_attention``: the outputs
    within ATTN_TOL and dq, dk, dv within :data:`GRAD_TOL`; (b) the whole
    ``attention_train`` of a layer with random weights against the same
    projections around the plain scan: the output and the gradients of x,
    wq, wk, wv, wo within :data:`GRAD_TOL`. One kernel launch in each of (a)
    and (b) (the timing runs between them are not counted); the plain side
    launches none. Also times (a)'s kernel forward and both routes' forward
    + backward."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models.attention import (
        FlashAttentionFn,
        attention_train,
        chunked_attention,
        init_attention,
        qkv,
    )

    cfg = get_config(TRAIN_ARCH)
    s, ck = TRAIN_SEQ, cfg.attn_chunk
    g = torch.Generator(device=dev).manual_seed(5)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev).to(
        torch.bfloat16)
    q, k, v = (rnd(1, s, h, cfg.head_dim).requires_grad_()
               for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    go = rnd(1, s, cfg.n_heads, cfg.head_dim)
    before = flash_attention_cuda.launches_tc
    o1 = FlashAttentionFn.apply(q, k, v, True, None, ck)
    d1 = torch.autograd.grad(o1, (q, k, v), go)
    o2 = chunked_attention(q, k, v, causal=True, chunk=ck)
    d2 = torch.autograd.grad(o2, (q, k, v), go)
    out = {"a_output": attn_err(o1.detach(), o2.detach()),
           **{f"a_d{n}": _within(a, b, GRAD_TOL)
              for n, a, b in zip("qkv", d1, d2)}}
    del o1, o2, d1, d2
    launched = flash_attention_cuda.launches_tc - before
    # What one layer's attention costs a training micro-step (CUDA events):
    # the kernel forward, and forward + backward on each route.
    with torch.no_grad():
        fwd = cuda_ms(lambda: FlashAttentionFn.apply(q, k, v, True, None, ck),
                      3, 1)
    fwd_bwd = cuda_ms(lambda: torch.autograd.grad(
        FlashAttentionFn.apply(q, k, v, True, None, ck), (q, k, v), go), 3, 1)
    plain = cuda_ms(lambda: torch.autograd.grad(
        chunked_attention(q, k, v, causal=True, chunk=ck), (q, k, v), go),
        2, 1)
    times = {"kernel_forward_ms": fwd, "flash_fn_forward_backward_ms": fwd_bwd,
             "flash_fn_backward_ms": fwd_bwd - fwd,
             "chunked_forward_backward_ms": plain}
    del q, k, v, go
    torch.cuda.empty_cache()
    before = flash_attention_cuda.launches_tc
    p = {n: t.requires_grad_() for n, t in init_attention(g, cfg, dev).items()}
    x = (rnd(1, s, cfg.d_model) * 0.5).requires_grad_()
    pos = torch.arange(s, device=dev)
    gy = rnd(1, s, cfg.d_model)
    leaves = (x, p["wq"], p["wk"], p["wv"], p["wo"])
    y1 = attention_train(p, x, cfg, pos, causal=True)
    e1 = torch.autograd.grad(y1, leaves, gy)
    qq, kk, vv = qkv(p, x, cfg, pos)
    y2 = chunked_attention(qq, kk, vv, causal=True, chunk=ck).reshape(
        1, s, -1) @ p["wo"]
    e2 = torch.autograd.grad(y2, leaves, gy)
    out["b_output"] = _within(y1.detach(), y2.detach(), GRAD_TOL)
    out.update({f"b_d{n}": _within(a, b, GRAD_TOL) for n, a, b in zip(
        ("x", "wq", "wk", "wv", "wo"), e1, e2)})
    launched += flash_attention_cuda.launches_tc - before
    if launched != 2:
        raise AssertionError(f"train_flash_grad: {launched} kernel launches")
    emit({"phase": "train_flash_grad", "arch": TRAIN_ARCH, "seq_len": s,
          "heads": [cfg.n_heads, cfg.n_kv_heads], "head_dim": cfg.head_dim,
          "max_abs_err": out, "tol_output": ATTN_TOL[torch.bfloat16],
          "tol_grad": GRAD_TOL, "kernel_launches": launched, **times})
    del p, x, y1, y2, e1, e2, qq, kk, vv
    torch.cuda.empty_cache()


def phase_train_parity(dev):
    """One usec step on the card against the same step on the host for
    reduced stablelm-1.6b, internvl2-2b and hubert-xlarge in fp32 (gradients
    accumulated in fp32; TF32 off): 4 workers, J = 2, S = 1, worker 1
    dropped, 160 positions a tile (> attn_chunk 64: the FFMA flash kernel
    under autograd on the card, the chunked scan on the host). Loss,
    gradient norm and every updated parameter and first moment within 1e-4
    of the host's largest value per leaf; on the card ``2 x attention
    layers`` FFMA launches per micro-step (remat)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import compile_plan, cyclic_placement, solve_assignment
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models import build_model
    from repro_torch.models.transformer import tree_leaves, tree_map
    from repro_torch.optim import adamw
    from repro_torch.runtime.executor import block_plan
    from repro_torch.runtime.trainstep import make_usec_train_step

    n = 4
    place = cyclic_placement(n, 2 * n, 2)
    plan = compile_plan(place, solve_assignment(place, np.ones(n),
                                                stragglers=1),
                        rows_per_tile=1, stragglers=1)
    b_max = int(plan.n_valid.max()) + 1
    for arch in TRAIN_PARITY_ARCHS:
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  param_dtype="float32",
                                  grad_accum_dtype="float32")
        pipe = TokenPipeline(cfg, place, seq_len=160, tile_samples=1, seed=1)
        sb = pipe.staged_for_step(0)
        bp = block_plan(plan, sb.slot_of, 1, stragglers=(1,), b_max=b_max)
        res = {}
        p_host = build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        for where in ("cpu", dev):
            bundle = build_model(cfg, device=where)
            params = tree_map(lambda t: t.to(where), p_host)
            step = make_usec_train_step(bundle, pipe.t_stage, b_max)
            ffma0 = flash_attention_cuda.launches_ffma
            new_p, new_o, _, m = step(params, adamw.init(params), None,
                                      sb.arrays, bp.blk_slot, bp.blk_include,
                                      bp.n_blocks[:, None], 1e-3)
            res[str(where)] = (m, tree_leaves(new_p) + tree_leaves(new_o["m"]),
                               flash_attention_cuda.launches_ffma - ffma0)
        (mh, lh, fh), (mc, lc, fc) = res["cpu"], res[str(dev)]
        want_ffma = 2 * attention_layer_count(cfg) * int(bp.n_blocks.sum())
        rel = lambda a, b: float((a.cpu().double() - b.double()).abs().max()
                                 / max(float(b.abs().max()), 1e-30))
        errs = {"loss": rel(mc["loss"], mh["loss"]),
                "grad_norm": rel(mc["grad_norm"], mh["grad_norm"]),
                "leaves": max(rel(a, b) for a, b in zip(lc, lh))}
        if max(errs.values()) > 1e-4 or fh != 0 or fc != want_ffma:
            raise AssertionError(f"train_parity {arch}: {errs}, ffma host "
                                 f"{fh} card {fc} want {want_ffma}")
        emit({"phase": "train_parity", "arch": cfg.name + " (reduced, fp32)",
              "seq_len": 160, "micro_steps": int(bp.n_blocks.sum()),
              "max_rel_err": errs, "tol": 1e-4, "ffma_launches": fc,
              "loss": float(mh["loss"])})


# ---------------------------------------------------------------------- #
# Training across processes, and the remat policies
# ---------------------------------------------------------------------- #
# train_dist: W = 4 ranks of the usec step for the train cell (internvl2-2b
# at full width; 4 workers, J = 2, S = 1, one worker dropped a step, 8192
# positions a tile, 3 steps). With 4 or more cards: NCCL, one card a rank,
# the trainer at full depth under python -m torch.distributed.run. With one
# card: NCCL refuses two ranks on one GPU, so 4 spawned ranks share cuda:0
# over gloo (which stages CUDA tensors through host memory), at DIST_DEPTH
# layers: each rank holds the replicated bf16 weights (the 92553 x 2048
# embedding and unembedding are 379M of them), fp32 AdamW moments, the fp32
# total and the attention backward's recompute, and the four ranks' peaks
# must sum to at most DIST_BUDGET_GB.
DIST_RANKS, DIST_DEPTH, DIST_BUDGET_GB = 4, 1, 70.0
DIST_DROP = (1, 2, 3)  # step s drops this worker and trains data step s
DIST_LR = 1e-3
DIST_MODES = ("fp32", "compressed")
# (share of a leaf's largest |value|) of the fp32-sum mode's parameters
# after 3 steps against the one-process step's: the ranks sum the same four
# fp32 totals in another order (1e-7 relative), which can move a bf16
# parameter across a rounding boundary (2^-8 of its value) and, where a
# gradient is near AdamW's eps, its update by up to 2 x DIST_LR; two bf16
# ulps of the leaf's top plus that.
DIST_PARAM_TOL = 2 ** -7
# train_remat: one training step (loss and gradients of one 8192-position
# tile) under each of the reference's remat policies. REMAT_DEPTH = 4 so
# that remat_sqrt forms groups (_inner_factor(4) = 2 blocks a group; at 1-3
# blocks it is plain per-block remat).
REMAT_DEPTH = 4
REMAT_POLICIES = {"remat": {"remat_save_outs": False, "remat_sqrt": False},
                  "remat_save_outs": {"remat_save_outs": True,
                                      "remat_sqrt": False},
                  "remat_sqrt": {"remat_save_outs": False,
                                 "remat_sqrt": True}}


def tensor_digest(t, chunk: int = 1 << 24) -> int:
    """An exact digest of a 4-byte tensor's bits: a position-weighted sum
    of its words, ``chunk`` elements at a time (equal tensors, equal
    digests)."""
    x = t.contiguous().view(torch.int32).reshape(-1)
    total = 0
    for i in range(0, x.numel(), chunk):
        part = x[i:i + chunk].to(torch.int64)
        w = torch.arange(i + 1, i + 1 + part.numel(), dtype=torch.int64,
                         device=x.device)
        total += int((part * (w * 2654435761)).sum())
    return total


def _dist_cell(dev, depth, arch=TRAIN_ARCH, n_workers=DIST_RANKS,
               drops=DIST_DROP, shards=None, cfg=None, seq=None):
    """The train cell of ``arch`` at ``depth`` layers over ``n_workers``
    workers (one tile each of ``seq`` positions, TRAIN_SEQ by default;
    worker ``drops[s]`` dropped at step s): (bundle, a function that makes
    the seed-0 weights, t_stage, b_max, each step's arguments, the
    attention layers). ``shards``: this rank's model group; ``cfg``: the
    config to use in place of ``arch``'s. The weights are made anew for
    each run, not held beside it."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import compile_plan, cyclic_placement, solve_assignment
    from repro_torch.data import TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.runtime.executor import block_plan

    cfg = dataclasses.replace(cfg or get_config(arch), n_layers=depth)
    bundle = build_model(cfg, device=dev, shards=shards)
    place = cyclic_placement(n_workers, n_workers, 2)
    pipe = TokenPipeline(cfg, place, seq_len=seq or TRAIN_SEQ,
                         tile_samples=1, seed=0)
    plan = compile_plan(place, solve_assignment(place, np.ones(n_workers),
                                                stragglers=1),
                        rows_per_tile=1, stragglers=1)
    b_max = int(plan.n_valid.max()) + 1
    args = []
    for s, bad in enumerate(drops):
        sb = pipe.staged_for_step(s)
        bp = block_plan(plan, sb.slot_of, 1, stragglers=(bad,), b_max=b_max)
        args.append((sb.arrays, bp.blk_slot, bp.blk_include,
                     bp.n_blocks[:, None], DIST_LR))
    return (bundle, lambda: bundle.init(torch.Generator(device=dev)
                                        .manual_seed(0)),
            pipe.t_stage, b_max, args, attention_layer_count(cfg))


def _run_steps(step, params, comp, args, dev, group=None, opt=None):
    """The steps of ``args`` from ``params`` (and ``opt``, by default fresh
    AdamW state like ``params``): (params, comp state, losses, grad norms,
    walls). With a group every step starts at a barrier."""
    from repro_torch.optim import adamw

    opt = adamw.init(params) if opt is None else opt
    out = {"loss": [], "grad_norm": [], "step_s": []}
    for a in args:
        if group is not None:
            torch.distributed.barrier(group)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, opt, comp, m = step(params, opt, comp, *a)
        torch.cuda.synchronize(dev)
        out["step_s"].append(time.perf_counter() - t0)
        if group is not None:
            # The old state is dropped now: ranks sharing the card get its
            # memory back.
            torch.cuda.empty_cache()
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    return params, comp, out


def _hold_to_one_process(mode, dist_run, digests, cell, dev):
    """On rank 0: the one-process step (all four workers in a loop, no
    group) from the same weights over the same steps, against ``mode``'s
    distributed result ``dist_run`` = (params, comp state, metrics). fp32:
    losses and gradient norms within 1e-6, parameters within
    DIST_PARAM_TOL; compressed: parameters and scales bitwise, every
    worker's error feedback by exact digest, losses within 1e-6 (the NLL
    sums ride an fp32 all-reduce)."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.runtime.compression import init_state
    from repro_torch.runtime.trainstep import make_usec_train_step

    bundle, init, t_stage, b_max, args, _ = cell
    params0 = init()
    comp = init_state(params0, DIST_RANKS) if mode == "compressed" else None
    step = make_usec_train_step(bundle, t_stage, b_max,
                                compress_grads=comp is not None)
    before = flash_attention_cuda.launches
    p1, c1, out1 = _run_steps(step, params0, comp, args, dev)
    del params0, comp
    launches = flash_attention_cuda.launches - before
    p_dist, c_dist, out_dist = dist_run
    errs = {k: max(abs(a - b) / abs(b) for a, b in zip(out_dist[k], out1[k]))
            for k in ("loss", "grad_norm")}
    errs["params"] = max(
        float((a.float() - b.float()).abs().max())
        / max(float(b.float().abs().max()), 1e-30)
        for a, b in zip(tree_leaves(p_dist), tree_leaves(p1)))
    ok = errs["loss"] <= 1e-6
    if mode == "fp32":
        ok &= errs["grad_norm"] <= 1e-6 and errs["params"] <= DIST_PARAM_TOL
    else:
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(p_dist) + tree_leaves(c_dist["scale"]),
            tree_leaves(p1) + tree_leaves(c1["scale"])))
        ef = tree_leaves(c1["ef"])
        seen = {w: d for part in digests for w, d in part.items()}
        ef_same = seen == {w: [tensor_digest(e[w]) for e in ef]
                           for w in range(DIST_RANKS)}
        errs.update(params_and_scales_bitwise=same,
                    each_worker_ef_bitwise=ef_same)
        ok &= same and ef_same and errs["grad_norm"] == 0.0
    return {"ok": bool(ok), "err": errs, "one_process": out1,
            "one_process_launches": launches}


def _dist_rank(rank, world, store, out_dir, depth, card_lock):
    """One gloo rank of train_dist on cuda:0 (spawned): both modes over
    the mesh, each then held to the one-process step by rank 0; writes
    ``rank{rank}.json``."""
    import datetime

    # Four processes share one card: no allocator slack left in segments.
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _take_turns(card_lock)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=600))
    try:
        res = _dist_rank_body(rank, world, dev, depth)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(res, fh)
    finally:
        torch.distributed.destroy_process_group()


def _dist_rank_body(rank, world, dev, depth):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch.mesh import make_worker_mesh, workers_of
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.runtime.compression import init_state
    from repro_torch.runtime.trainstep import (
        make_usec_train_step,
        value_and_grad,
    )

    mesh = make_worker_mesh(DIST_RANKS, device_type="cuda")
    group = mesh.get_group()
    cell = _dist_cell(dev, depth)
    bundle, init, t_stage, b_max, args, n_attn = cell
    mine = workers_of(rank, world, DIST_RANKS)
    micro = sum(int(a[3][mine.start:mine.stop].sum()) for a in args)
    res = {"rank": rank, "workers": list(mine), "micro_steps": micro,
           "attention_layers": n_attn, "modes": {}, "held": {}}
    # A fresh process's first forward and backward pays its one-time costs
    # (~10 s); the ranks pay them together, outside the timed steps and
    # the turns, on their first worker's first tile.
    marks = res["marks"] = {"warmup": time.time()}
    t0 = time.perf_counter()
    staged, slot = args[0][0], int(args[0][1][mine.start, 0])
    params0 = init()
    value_and_grad(bundle.loss_fn, params0, {
        k: torch.as_tensor(v[mine.start, slot], device=dev)
        for k, v in staged.items()})
    torch.cuda.synchronize(dev)
    res["warmup_s"] = time.perf_counter() - t0
    del params0
    gc.collect()
    torch.cuda.empty_cache()
    for mode in DIST_MODES:
        marks[mode] = time.time()
        params0 = init()
        comp = init_state(params0, len(mine)) if mode == "compressed" \
            else None
        step = make_usec_train_step(bundle, t_stage, b_max,
                                    compress_grads=comp is not None,
                                    group=group)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        before = flash_attention_cuda.launches
        params, comp, out = _run_steps(step, params0, comp, args, dev, group)
        del params0
        out.update(
            flash_launches=flash_attention_cuda.launches - before,
            max_memory_allocated_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
            max_memory_reserved_gb=torch.cuda.max_memory_reserved(dev) / 1e9,
            reduced_bytes_per_step=step.stats["bytes"] / len(args),
            collectives_per_step=step.stats["collectives"] / len(args))
        res["modes"][mode] = out
        del step
        mine_digests = {} if comp is None else {
            w: [tensor_digest(e[i]) for e in tree_leaves(comp["ef"])]
            for i, w in enumerate(mine)}
        digests = [None] * world
        torch.distributed.all_gather_object(digests, mine_digests,
                                            group=group)
        dist_run = (params, comp, out)
        del params, comp
        if rank != 0:
            dist_run = None
        gc.collect()
        torch.cuda.empty_cache()
        # Every rank has handed its free memory back before rank 0 runs
        # the one-process step.
        torch.distributed.barrier(group)
        marks[f"held_{mode}"] = time.time()
        if rank == 0:
            res["held"][mode] = _hold_to_one_process(mode, dist_run,
                                                     digests, cell, dev)
            dist_run = None
            gc.collect()
            torch.cuda.empty_cache()
        torch.distributed.barrier(group)
    return res


def _take_turns(lock) -> None:
    """Ranks sharing one card take turns with its memory: each holds
    ``lock`` through its usec step's local work (the micro-steps, the
    quantization, AdamW) and lets it go across the step's all-reduces,
    handing its free cached memory back first. So one rank at a time holds
    those transients, beside the others' resident state. (The card runs
    one process's kernels at a time anyway; the all-reduces are what the
    ranks do together.)"""
    from repro_torch.runtime import trainstep

    dist, make = torch.distributed, trainstep.make_usec_train_step
    all_reduce = dist.all_reduce

    def hand_back():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    def released_all_reduce(*args, **kwargs):
        hand_back()
        lock.release()
        try:
            return all_reduce(*args, **kwargs)
        finally:
            lock.acquire()

    def make_taking_turns(*args, **kwargs):
        step = make(*args, **kwargs)

        def turn(*step_args):
            with lock:
                out = step(*step_args)
                hand_back()
            return out

        turn.stats = step.stats
        return turn

    dist.all_reduce = released_all_reduce
    trainstep.make_usec_train_step = make_taking_turns


def _one_rank_nccl(dev):
    """One NCCL group of one rank issues every collective of the usec step,
    both modes, on the card (reduced internvl2-2b in fp32, 4 workers,
    160 positions a tile): its results bitwise the step without a group
    (an all-reduce over one rank is a copy), and each collective's dtype
    and op recorded."""
    import dataclasses
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.core import compile_plan, cyclic_placement, solve_assignment
    from repro_torch.data import TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.runtime.compression import init_state
    from repro_torch.runtime.executor import block_plan
    from repro_torch.runtime.trainstep import make_usec_train_step

    dist = torch.distributed
    cfg = dataclasses.replace(get_config(TRAIN_ARCH).reduced(),
                              param_dtype="float32")
    bundle = build_model(cfg, device=dev)
    params0 = bundle.init(torch.Generator(device=dev).manual_seed(0))
    place = cyclic_placement(4, 8, 2)
    pipe = TokenPipeline(cfg, place, seq_len=160, tile_samples=1, seed=1)
    plan = compile_plan(place, solve_assignment(place, np.ones(4),
                                                stragglers=1),
                        rows_per_tile=1, stragglers=1)
    b_max = int(plan.n_valid.max()) + 1
    sb = pipe.staged_for_step(0)
    bp = block_plan(plan, sb.slot_of, 1, stragglers=(1,), b_max=b_max)
    args = [(sb.arrays, bp.blk_slot, bp.blk_include, bp.n_blocks[:, None],
             DIST_LR)]
    seen = []
    real = dist.all_reduce

    def spy(tensor, op=dist.ReduceOp.SUM, group=None, async_op=False):
        seen.append((str(tensor.dtype).replace("torch.", ""), str(op)))
        return real(tensor, op=op, group=group, async_op=async_op)

    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/store",
                                rank=0, world_size=1, device_id=dev)
        dist.all_reduce = spy
        try:
            out = {}
            for mode in DIST_MODES:
                comp = (lambda: init_state(params0, 4)) \
                    if mode == "compressed" else (lambda: None)
                got = []
                for group in (dist.group.WORLD, None):
                    step = make_usec_train_step(
                        bundle, pipe.t_stage, b_max,
                        compress_grads=mode == "compressed", group=group)
                    p, c, m = _run_steps(step, params0, comp(), args, dev)
                    got.append(tree_leaves(p) + ([] if c is None else
                                                 tree_leaves(c)) + [m])
                same = all(torch.equal(a, b) for a, b in zip(got[0][:-1],
                                                             got[1][:-1]))
                metrics = [{k: m[k] for k in ("loss", "grad_norm")}
                           for m in (got[0][-1], got[1][-1])]
                out[mode] = {"bitwise": same and metrics[0] == metrics[1],
                             "collectives": sorted(set(seen))}
                seen.clear()
        finally:
            dist.all_reduce = real
            dist.destroy_process_group()
    return out


def phase_train_dist(dev, smi, train_metrics):
    """W = 4 ranks of the usec step (see DIST_RANKS). With 4 or more cards:
    NCCL, the trainer at full depth under torch.distributed.run, each
    step's loss and gradient norm held to ``train_metrics`` (train_path's
    one-process run). With one card: 4 spawned gloo ranks on cuda:0 at
    DIST_DEPTH layers, fp32 and compressed, held to the one-process step.
    In both cases one NCCL group of one rank issues every collective the
    step uses. Returns the ranks' flash launches (summed)."""
    cards = torch.cuda.device_count()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    if cards >= DIST_RANKS:
        record = _train_dist_nccl(train_metrics)
    else:
        record = _train_dist_gloo()
    record["one_rank_nccl"] = _one_rank_nccl(dev)
    record.update(cards=cards, ranks=DIST_RANKS, phase_s=time.perf_counter()
                  - t0, nvidia_smi=smi)
    emit({"phase": "train_dist", **record})
    bad = [m for m, r in record["one_rank_nccl"].items() if not r["bitwise"]]
    if bad or not record.pop("ok"):
        raise AssertionError(f"train_dist failed (one-rank NCCL {bad})")
    gc.collect()
    torch.cuda.empty_cache()
    return record["flash_launches"]


def _train_dist_gloo():
    """4 spawned gloo ranks on one card, taking turns with the card's
    memory (:func:`_take_turns`); the card's memory in use (every process,
    CUDA contexts included) sampled every 50 ms from this process."""
    import multiprocessing
    import shutil
    import threading

    out_dir = os.path.join(ROOT, "build", "train_dist")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    ctx = multiprocessing.get_context("spawn")
    lock = ctx.Lock()
    procs = [ctx.Process(target=_dist_rank, args=(
        r, DIST_RANKS, os.path.join(out_dir, "store"), out_dir, DIST_DEPTH,
        lock)) for r in range(DIST_RANKS)]
    used, stop = [], threading.Event()

    def sample():
        while not stop.wait(0.05):
            free, total = torch.cuda.mem_get_info(0)
            used.append((total - free, time.time()))

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=900)
    finally:
        stop.set()
        sampler.join()
        for p in procs:
            if p.is_alive():
                p.kill()
    wall = time.perf_counter() - t0
    codes = [p.exitcode for p in procs]
    if codes != [0] * DIST_RANKS:
        raise AssertionError(f"train_dist ranks exited {codes}")
    ranks = []
    for r in range(DIST_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    held = ranks[0].pop("held")
    for rank in ranks[1:]:
        rank.pop("held")
    launches_ok = all(
        rank["modes"][m]["flash_launches"]
        == 2 * rank["attention_layers"] * rank["micro_steps"]
        for rank in ranks for m in DIST_MODES)
    card_peak, peak_at = max(used)
    card_peak /= 1e9
    # The stage of the peak: the last stage rank 0 had begun by then.
    peak_stage = max((t, stage) for stage, t in ranks[0]["marks"].items()
                     if t <= peak_at)[1]
    ok = (launches_ok and all(h["ok"] for h in held.values())
          and card_peak <= DIST_BUDGET_GB
          and all(len({rank["modes"][m]["loss"][s] for rank in ranks}) == 1
                  for m in DIST_MODES for s in range(len(DIST_DROP))))
    return {"backend": "gloo", "depth": DIST_DEPTH,
            "reduced": {"n_layers": [24, DIST_DEPTH]},
            "why_gloo": "NCCL refuses two ranks on one GPU",
            "ranks_detail": ranks, "held": held, "ranks_wall_s": wall,
            "card_peak_used_gb": card_peak, "card_peak_stage": peak_stage,
            "budget_gb": DIST_BUDGET_GB,
            "sum_of_rank_peaks_gb": {
                m: sum(rank["modes"][m]["max_memory_allocated_gb"]
                       for rank in ranks) for m in DIST_MODES},
            "flash_launches": sum(rank["modes"][m]["flash_launches"]
                                  for rank in ranks for m in DIST_MODES),
            "ok": bool(ok)}


def _train_dist_nccl(train_metrics):
    """The trainer at full depth on 4 cards under torch.distributed.run
    (NCCL, one card a rank): rank 0's losses and gradient norms against
    train_path's one-process run, and each rank's report."""
    import re

    from repro_torch.configs import get_config

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(DIST_RANKS), "-m", "repro_torch.launch.train"]
        + TRAIN_ARGS, capture_output=True, text=True, timeout=900, env=env,
        cwd=ROOT)
    if proc.returncode != 0:
        raise AssertionError(f"torch.distributed.run exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    steps = [(float(a), float(b)) for a, b in re.findall(
        r"^step +\d+ loss=([0-9.]+) gnorm=([0-9.]+)", proc.stdout, re.M)]
    reports = [json.loads(x) for x in re.findall(
        r"^rank \d+ of \d+: (\{.*\})$", proc.stdout, re.M)]
    want = [(m["loss"], m["grad_norm"]) for m in train_metrics]
    # The log prints 4 decimals of the loss and 3 of the norm; the ranks
    # sum the fp32 totals in another order (1e-7 relative).
    errs = [(abs(a - c), abs(b - d)) for (a, b), (c, d) in zip(steps, want)]
    n_attn = attention_layer_count(get_config(TRAIN_ARCH))
    launches_ok = len(reports) == DIST_RANKS and all(
        r["attention_kernel_launches"] == 2 * n_attn * r["micro_steps"]
        for r in reports)
    ok = (len(steps) == len(want) == TRAIN_STEPS and launches_ok
          and all(e1 <= 1.5e-4 and e2 <= 1.5e-3 for e1, e2 in errs))
    return {"backend": "nccl", "depth": "full", "args": TRAIN_ARGS,
            "losses_grad_norms": steps, "one_process": want,
            "abs_err": errs, "ranks_detail": reports,
            "flash_launches": sum(r["attention_kernel_launches"]
                                  for r in reports),
            "ok": bool(ok)}


# ---------------------------------------------------------------------- #
# Training over model shards
# ---------------------------------------------------------------------- #
# train_tp: glm4-9b at full width, TP_DEPTH layer, each worker's model split
# over TP_SHARDS ranks (D = 1 x M = 2), TP_WORKERS workers (cyclic J = 2
# over 2 tiles of one 8192-position sample, S = 1, worker TP_DROP[s]
# dropped at step s), 2 steps. NCCL refuses two ranks on one GPU, so 2
# spawned gloo ranks share cuda:0, both at once (every layer has a
# collective, so they cannot take turns). Reckoning at 1 layer: 1.446 B
# parameters (the 151552 x 4096 embedding and unembedding are 1.24 B of
# them), 0.72 B a rank: 1.45 GB of bf16 weights, 5.8 GB of fp32 moments,
# 2.9 + 2.9 GB of fp32 accumulator and total, 7.2 GB more inside the AdamW
# update, about 20 GB a rank; the whole draw (2.9 GB) before the cut. Then
# rank 0 runs the one-process step alone (about 41 GB).
TP_DEPTH, TP_SHARDS, TP_WORKERS, TP_DROP = 1, 2, 2, (1, 0)
# Tolerances of the sharded bf16 step against the one-process step. Each
# rank's partial product is rounded to bf16 before the fp32 sum of the
# reduction (the one-process product rounds once), so an activation may
# differ by one bf16 ulp (2^-8 relative) here and there; the loss, a mean
# over 8192 positions a tile, moves far less: 1e-3 relative. A gradient
# norm sums bf16 gradients that each may differ by a few ulps: 1e-2. A
# parameter: AdamW's first updates are about lr x sign(g) (g / (|g| +
# eps)), so where g is near 0 the two runs may step apart by 2 lr a step;
# at most TP_PARAM_SHARE of a leaf's elements may differ by more than two
# bf16 ulps of the leaf's largest value, and none by more than
# 3 x lr x steps plus that.
TP_LOSS_TOL, TP_GNORM_TOL, TP_PARAM_SHARE = 1e-3, 1e-2, 1e-2


def _card_rank(body, rank, world, store, out_dir):
    """One gloo rank on cuda:0 (spawned by :func:`_ranks_on_card`): joins
    the group and writes ``body(rank, dev)``'s record to
    ``rank{rank}.json``."""
    import datetime

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.zeros(1, device=dev)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=600))
    try:
        res = body(rank, dev)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(res, fh)
    finally:
        torch.distributed.destroy_process_group()


def _tp_rank_body(rank, dev):
    """train_tp's steps over the 1 x 2 mesh; rank 0 then holds them to the
    one-process step."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch.mesh import (
        coordinates,
        data_group,
        make_worker_mesh,
        model_group,
    )
    from repro_torch.models import attention
    from repro_torch.models.parallel import ModelShards, unshard_params
    from repro_torch.runtime.trainstep import make_usec_train_step

    dist = torch.distributed
    mesh = make_worker_mesh(TP_WORKERS, TP_SHARDS, device_type="cuda")
    _, m = coordinates(mesh)
    shards = ModelShards(model_group(mesh), TP_SHARDS, m)
    cell = _dist_cell(dev, TP_DEPTH, MODEL_ARCH, TP_WORKERS, TP_DROP, shards)
    bundle, init, t_stage, b_max, args, n_attn = cell
    shapes = set()
    flash = attention._flash

    def spy(q, k, v, causal, window):
        shapes.add((tuple(q.transpose(1, 2).shape), k.shape[2]))
        return flash(q, k, v, causal, window)

    attention._flash = spy
    step = make_usec_train_step(bundle, t_stage, b_max,
                                group=data_group(mesh))
    params = init()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    before = flash_attention_cuda.launches
    params, _, out = _run_steps(step, params, None, args, dev,
                                dist.group.WORLD)
    attention._flash = flash
    micro = sum(int(a[3].sum()) for a in args)
    res = {"rank": rank, "model_index": m, "micro_steps": micro,
           "attention_layers": n_attn, **out,
           "flash_launches": flash_attention_cuda.launches - before,
           "flash_shapes": sorted([list(q), hk] for q, hk in shapes),
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated(dev) / 1e9,
           "tp_bytes_per_step": shards.stats["bytes"] / len(args),
           "tp_collectives_per_step": shards.stats["collectives"] / len(args),
           "reduced_bytes_per_step": step.stats["bytes"] / len(args)}
    whole = unshard_params(params, bundle.cfg, shards, device="cpu")
    del params, step, bundle, init, cell
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        res["held"] = _hold_tp(whole, out, dev)
    dist.barrier()
    return res


def _hold_tp(whole, out_tp, dev):
    """The one-process step from the same weights over the same steps,
    against the sharded run (its losses, gradient norms and gathered
    parameters) within the TP_* tolerances."""
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.runtime.trainstep import make_usec_train_step

    bundle, init, t_stage, b_max, args, _ = _dist_cell(
        dev, TP_DEPTH, MODEL_ARCH, TP_WORKERS, TP_DROP)
    step = make_usec_train_step(bundle, t_stage, b_max)
    torch.cuda.reset_peak_memory_stats(dev)
    p1, _, out1 = _run_steps(step, init(), None, args, dev)
    return _held_to_one_process(whole, out_tp, p1, out1, len(args), dev)


def _held_to_one_process(whole, out, p1, out1, n_steps, dev):
    """A sharded bf16 run (its losses and gradient norms ``out`` and its
    gathered parameters ``whole``) against the one-process run's (``out1``,
    ``p1``) within the TP_* tolerances."""
    errs = {k: max(abs(a - b) / abs(b) for a, b in zip(out[k], out1[k]))
            for k in ("loss", "grad_norm")}
    params = params_held(whole, p1, n_steps, dev)
    ok = (errs["loss"] <= TP_LOSS_TOL and errs["grad_norm"] <= TP_GNORM_TOL
          and params.pop("ok"))
    return {"ok": bool(ok), "err": errs, **params, "one_process": out1,
            "one_process_peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def params_held(whole, p1, n_steps, dev, m1=None, m2=None, floor=0.0,
                tol=2 ** -7, share_tol=TP_PARAM_SHARE, m_tol=None,
                live_sigmas=None, coverage=None, coverage_over=None):
    """The TP_* rule for a sharded run's gathered parameters ``whole``
    against the one-process run's ``p1`` after ``n_steps`` steps: at most
    ``share_tol`` of a leaf's elements more than ``tol`` (two bf16 ulps) of
    its largest value apart, and none by more than 3 x DIST_LR a step past
    that.

    With the runs' first moments (``m1``, the one-process run's, and
    ``m2``), the share counts only a leaf's live elements, those with
    ``|m1| >= floor`` (the CPU tests' rule: AdamW's update is about lr x
    sign(g) wherever |g| is small, so where a gradient is zero to rounding
    the two runs may move an element by up to 2 lr apart), and with
    ``m_tol`` (a function of the leaf's key) each leaf's live moments are
    held within ``m_tol(key)`` of the leaf's largest. Every leaf with an element off (or, with moments, a
    moment off) is listed in ``leaves``: its key, size, share off, worst
    excess over ``tol``, the largest |m1| of the leaf and of its off
    elements, and ``m_err``, the largest |m2 - m1| over live elements
    against the largest |m1|.

    ``live_sigmas`` (with the moments; ``floor`` is then unused): the live
    set comes from each leaf's own layout noise, sigma, the rms over the
    leaf of ``m2 - m1``: live where ``|m1| >= live_sigmas x sigma``, and
    the share is of the leaf's live elements. ``coverage`` = (ratio,
    least): every leaf whose sigma is below ``ratio`` x its largest |m1|
    must keep at least ``least`` of its elements live; ``coverage_over``
    maps a leaf's key to (dim, indices): that leaf's share is then of the
    live elements among those indices along that dim (a sparse-gradient
    leaf's rows or columns the batch touches). Every leaf's live share and
    sigma (as a share of its largest |m1|) are listed in ``live``."""
    from repro_torch.launch.sharding import keystr, map_with_path
    from repro_torch.models.transformer import tree_leaves

    keys = []
    map_with_path(lambda path, _: keys.append(keystr(path)), p1)
    moments = ([None] * len(keys) if m1 is None
               else list(zip(tree_leaves(m1), tree_leaves(m2))))
    share, worst, ok, rows, lives = 0.0, 0.0, True, [], []
    step_bound = 3 * DIST_LR * n_steps
    for key, a, b, mm in zip(keys, tree_leaves(whole), tree_leaves(p1),
                             moments):
        a, b = a.to(dev).float(), b.to(dev).float()
        top = float(b.abs().max())
        diff = (a - b).abs()
        off = diff > tol * top
        excess = float(diff.max()) - tol * top
        row = {"leaf": key, "n": b.numel(), "excess_over_tol": excess}
        del a, b, diff
        live = None
        if mm is not None:
            g1, g2 = (t.to(dev).float() for t in mm)
            g_top = float(g1.abs().max())
            if live_sigmas is None:
                live = g1.abs() >= floor
            else:
                sigma = float((g2 - g1).square().mean().sqrt())
                live = g1.abs() >= live_sigmas * sigma
                rel = sigma / g_top if g_top > 0 else 0.0
                entry = {"leaf": key, "live_share": float(
                    live.float().mean()), "sigma_over_top": rel}
                covered = entry["live_share"]
                if coverage_over and key in coverage_over:
                    dim, idx = coverage_over[key]
                    covered = float(live.index_select(
                        dim, idx.to(live.device)).float().mean())
                    entry["coverage_share"] = covered
                if coverage is not None and rel < coverage[0] and \
                        covered < coverage[1]:
                    ok = False
                    entry["coverage_failed"] = True
                lives.append(entry)
            m_err = (float(((g2 - g1).abs() * live).max()) / g_top
                     if g_top > 0 else 0.0)
            row.update(max_abs_m1=g_top, live_share=float(
                live.float().mean()), m_err=m_err,
                max_abs_m1_off=float((g1.abs() * off).max()))
            del g1, g2
            if m_tol is not None and m_err > m_tol(key):
                ok = False
                row["m_over_tol"] = True
        row["share_off"] = float(off.float().mean())
        held_off = off if live is None else off & live
        row["share_off_live"] = float(held_off.float().mean())
        if live_sigmas is not None:  # of the live elements
            row["share_off_live"] = float(held_off.sum()) / max(
                float(live.sum()), 1.0)
        share = max(share, row["share_off_live"])
        worst = max(worst, excess)
        if row["share_off"] > 0 or row.get("m_over_tol"):
            rows.append(row)
        del off, live, held_off
    ok &= share <= share_tol and worst <= step_bound
    out = {"ok": bool(ok), "param_share_off": share,
           "param_excess_over_2ulps": worst, "param_step_bound": step_bound,
           "leaves": rows}
    if live_sigmas is not None:
        out["live"] = lives
    return out


def _ranks_on_card(body, world, name):
    """``world`` spawned gloo ranks sharing cuda:0, each running
    ``body(rank, dev)`` (:func:`_card_rank`), the card's memory in use
    (every process) sampled every 50 ms from this process: (each rank's
    record, wall seconds, the sampled peak in GB)."""
    import functools
    import multiprocessing
    import shutil
    import threading

    gc.collect()
    torch.cuda.empty_cache()
    out_dir = os.path.join(ROOT, "build", name)
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=functools.partial(_card_rank, body), args=(
        r, world, os.path.join(out_dir, "store"), out_dir))
        for r in range(world)]
    used, stop = [], threading.Event()

    def sample():
        while not stop.wait(0.05):
            free, total = torch.cuda.mem_get_info(0)
            used.append(total - free)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=900)
    finally:
        stop.set()
        sampler.join()
        for p in procs:
            if p.is_alive():
                p.kill()
    wall = time.perf_counter() - t0
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise AssertionError(f"{name} ranks exited {codes}")
    ranks = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    return ranks, wall, max(used) / 1e9


def phase_train_tp(dev, smi):
    """TP_SHARDS gloo ranks on cuda:0 train glm4-9b at full width over a
    1 x 2 mesh (see TP_DEPTH), held to the one-process step; the card's
    memory in use sampled from this process. Returns the ranks' flash
    launches (summed)."""
    ranks, wall, card_peak = _ranks_on_card(_tp_rank_body, TP_SHARDS,
                                            "train_tp")
    held = ranks[0].pop("held")
    local_heads = [[1, 32 // TP_SHARDS, TRAIN_SEQ, 128], 1]
    launches_ok = all(
        rank["flash_launches"] == 2 * rank["attention_layers"]
        * rank["micro_steps"] and rank["flash_shapes"] == [local_heads]
        for rank in ranks)
    same = all(rank["loss"] == ranks[0]["loss"]
               and rank["grad_norm"] == ranks[0]["grad_norm"]
               for rank in ranks)
    record = {"phase": "train_tp", "arch": MODEL_ARCH, "depth": TP_DEPTH,
              "reduced": {"n_layers": [40, TP_DEPTH]}, "seq_len": TRAIN_SEQ,
              "mesh": [1, TP_SHARDS], "workers": TP_WORKERS,
              "backend": "gloo",
              "why_gloo": "NCCL refuses two ranks on one GPU",
              "ranks_detail": ranks, "held": held, "ranks_wall_s": wall,
              "card_peak_used_gb": card_peak,
              "tolerances": {"loss": TP_LOSS_TOL, "grad_norm": TP_GNORM_TOL,
                             "param_share": TP_PARAM_SHARE},
              "flash_launches": sum(r["flash_launches"] for r in ranks),
              "nvidia_smi": smi}
    emit(record)
    if not (held["ok"] and launches_ok and same):
        raise AssertionError(f"train_tp failed: held {held['ok']}, launches "
                             f"{launches_ok}, ranks agree {same}")
    gc.collect()
    torch.cuda.empty_cache()
    return record["flash_launches"]


# ---------------------------------------------------------------------- #
# Training with parameters and optimizer state cut over the data axis
# ---------------------------------------------------------------------- #
# train_fsdp: FSDP_RANKS gloo ranks share cuda:0 (D 2 x M 1), both at once
# (every layer gathers over the data group). (i) The sharded fsdp step:
# glm4-9b at full width and FSDP_DEPTH layer under the fsdp rules
# (train_mode replaced, as the reference's dry-run does), FSDP_ROWS rows of
# 8192 positions in FSDP_MICRO microbatches with weights FSDP_WEIGHTS,
# FSDP_STEPS steps; every data cut runs: wq on its dim 0, wo on dim 1, the
# embedding and unembedding. Held to the one-process fsdp step (rank 0,
# after both ranks free the card) at the TP_* tolerances. qwen1.5-110b at
# 1 layer (3.85 B parameters, ~54 GB of state at 14 B a parameter) leaves
# too little room for two ranks' gathers on one card, hence glm4-9b
# (1.446 B). (ii) ZeRO-1: the usec step on internvl2-2b at DIST_DEPTH, 2
# workers (ZERO1_DROP), with reduced_grad_shardings against the same two
# ranks without it: losses bitwise, gradient norms and parameters within
# ZERO1_TOL (of a leaf's largest value). Both are bitwise in practice: the
# two ranks' fp32 totals add in either order to the same sums, and the norm
# accumulates in fp64, so it rounds to the same fp32 value from slices.
FSDP_RANKS, FSDP_DEPTH, FSDP_ROWS, FSDP_MICRO, FSDP_STEPS = 2, 1, 4, 2, 2
FSDP_WEIGHTS = (1.0, 0.0, 1.0, 1.0)
# (a rank's slice, the dim gathered): wq on dim 0, wo on dim 1, the
# embedding and the unembedding.
FSDP_GATHERS = {((2048, 4096), 0), ((4096, 2048), 1), ((151552, 2048), 1),
                ((2048, 151552), 0)}
ZERO1_DROP, ZERO1_TOL = (1, 0), 1e-6


def _zero1_moments(cfg, dev, n_data, d, shards=None):
    """Fresh AdamW state cut as ZeRO-1 cuts it (data index ``d``; model
    shard ``shards.rank``)."""
    from types import SimpleNamespace

    from repro_torch.models.parallel import meta_params, shard_params
    from repro_torch.models.transformer import tree_map
    from repro_torch.optim import adamw

    m = (1, 0) if shards is None else (shards.size, shards.rank)
    cut = shard_params(meta_params(cfg), cfg, *m, n_data, d, moments=True)
    return adamw.init(tree_map(
        lambda t: SimpleNamespace(shape=t.shape, device=dev), cut))


def _fsdp_cfg():
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(MODEL_ARCH), n_layers=FSDP_DEPTH,
                               train_mode="fsdp")


def _fsdp_steps(step, params, opt, dev, group=None):
    """FSDP_STEPS steps of the fsdp cell: (params, losses, norms, walls)."""
    from repro_torch.configs.shapes import demo_batch

    batch = demo_batch(_fsdp_cfg(), "train", FSDP_ROWS, TRAIN_SEQ)
    weights = np.asarray(FSDP_WEIGHTS, np.float32)
    out = {"loss": [], "grad_norm": [], "step_s": []}
    for _ in range(FSDP_STEPS):
        if group is not None:
            torch.distributed.barrier(group)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch, weights, DIST_LR)
        torch.cuda.synchronize(dev)
        out["step_s"].append(time.perf_counter() - t0)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    return params, out


def _fsdp_rank_body(rank, dev):
    """train_fsdp's two parts on this rank (ZeRO-1 first, then the sharded
    fsdp step); rank 0 then holds the latter to the one-process step."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch.mesh import data_group, make_worker_mesh
    from repro_torch.models import build_model, parallel
    from repro_torch.models.parallel import DataShards, unshard_params
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.runtime.trainstep import (
        make_fsdp_train_step,
        make_usec_train_step,
    )

    dist = torch.distributed
    group = data_group(make_worker_mesh(FSDP_RANKS, device_type="cuda"))
    res = {"rank": rank, "zero1": {}}
    # (ii) ZeRO-1 on the usec step, against the same ranks without it.
    bundle, init, t_stage, b_max, args, n_attn = _dist_cell(
        dev, DIST_DEPTH, TRAIN_ARCH, FSDP_RANKS, ZERO1_DROP)
    specs = _zero1_specs(bundle.cfg, FSDP_RANKS)
    micro = sum(int(a[3][rank]) for a in args)
    for zero1 in (False, True):
        step = make_usec_train_step(bundle, t_stage, b_max, group=group,
                                    reduced_grad_shardings=specs if zero1
                                    else None)
        params0 = init()
        opt = _zero1_moments(bundle.cfg, dev, FSDP_RANKS, rank) if zero1 \
            else None
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        before = flash_attention_cuda.launches
        params, _, out = _run_steps(step, params0, None, args, dev, group,
                                    opt)
        del params0, opt
        res["zero1"][str(zero1)] = dict(
            out, flash_launches=flash_attention_cuda.launches - before,
            max_memory_allocated_gb=torch.cuda.max_memory_allocated(dev)
            / 1e9, data_bytes_per_step=step.stats["bytes"] / len(args))
        res["zero1"][str(zero1)]["params"] = params
        del step, params
    res["zero1_micro_steps"], res["zero1_attention_layers"] = micro, n_attn
    a, b = res["zero1"]["True"], res["zero1"]["False"]
    pa, pb = a.pop("params"), b.pop("params")
    res["zero1_err"] = {
        "loss_bitwise": a["loss"] == b["loss"],
        "grad_norm": max(abs(x - y) / abs(y) for x, y in
                         zip(a["grad_norm"], b["grad_norm"])),
        "params": max(float((x.float() - y.float()).abs().max())
                      / max(float(y.float().abs().max()), 1e-30)
                      for x, y in zip(tree_leaves(pa), tree_leaves(pb)))}
    del pa, pb, bundle, init
    gc.collect()
    torch.cuda.empty_cache()
    # (i) The sharded fsdp step.
    cfg = _fsdp_cfg()
    data = DataShards(group, FSDP_RANKS, rank)
    bundle = build_model(cfg, device=dev, data=data)
    gathered = set()
    gather_dim = parallel.gather_dim

    def spy(x, dp, dim):
        if dp is data:
            gathered.add((tuple(x.shape), dim))
        return gather_dim(x, dp, dim)

    parallel.gather_dim = spy
    step = make_fsdp_train_step(bundle, FSDP_MICRO, donate=True)
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    opt = _zero1_moments(cfg, dev, FSDP_RANKS, rank)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    before = flash_attention_cuda.launches
    params, out = _fsdp_steps(step, params, opt, dev, group)
    parallel.gather_dim = gather_dim
    res["fsdp"] = dict(
        out, flash_launches=flash_attention_cuda.launches - before,
        micro_steps=FSDP_MICRO * FSDP_STEPS,
        attention_layers=attention_layer_count(cfg),
        max_memory_allocated_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        gathers=sorted(gathered),
        layer_data_bytes_per_step=data.stats["bytes"] / FSDP_STEPS,
        step_data_bytes_per_step=step.stats["bytes"] / FSDP_STEPS,
        resting_gb=sum(t.numel() * t.element_size()
                       for t in tree_leaves(params)) / 1e9)
    whole = unshard_params(params, cfg, None, device="cpu", dp=data)
    del params, opt, step, bundle
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        one = build_model(cfg, device=dev)
        step = make_fsdp_train_step(one, FSDP_MICRO, donate=True)
        torch.cuda.reset_peak_memory_stats(dev)
        p1, out1 = _fsdp_steps(step, one.init(torch.Generator(
            device=dev).manual_seed(0)), _zero1_moments(cfg, dev, 1, 0), dev)
        res["held"] = _held_to_one_process(whole, res["fsdp"], p1, out1,
                                           FSDP_STEPS, dev)
        del p1, step, one
    dist.barrier()
    return res


def _zero1_specs(cfg, n_data, n_model=1):
    """ZeRO-1's moment specs (``opt_shardings``) on an (n_data, n_model)
    mesh."""
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.models.parallel import meta_params

    mesh = MeshSpec((n_data, n_model), ("data", "model"))
    shapes = meta_params(cfg)
    return sharding.opt_shardings(sharding.param_shardings(shapes, cfg, mesh),
                                  mesh, shapes)["m"]


def phase_train_fsdp(dev, smi):
    """FSDP_RANKS gloo ranks on cuda:0: the sharded fsdp step (held to the
    one-process step) and ZeRO-1 (held to the same ranks without it). Returns
    the ranks' flash launches (summed)."""
    ranks, wall, card_peak = _ranks_on_card(_fsdp_rank_body, FSDP_RANKS,
                                            "train_fsdp")
    held = ranks[0].pop("held")
    fsdp_ok = all(
        r["fsdp"]["flash_launches"] == 2 * r["fsdp"]["attention_layers"]
        * r["fsdp"]["micro_steps"]
        and r["fsdp"]["loss"] == ranks[0]["fsdp"]["loss"]
        and FSDP_GATHERS <= {(tuple(g[0]), g[1])
                             for g in r["fsdp"]["gathers"]}
        for r in ranks)
    zero1_ok = all(
        r["zero1_err"]["loss_bitwise"]
        and r["zero1_err"]["grad_norm"] <= ZERO1_TOL
        and r["zero1_err"]["params"] <= ZERO1_TOL
        and all(m["flash_launches"] == 2 * r["zero1_attention_layers"]
                * r["zero1_micro_steps"] for m in r["zero1"].values())
        for r in ranks)
    launches = sum(r["fsdp"]["flash_launches"]
                   + sum(m["flash_launches"] for m in r["zero1"].values())
                   for r in ranks)
    emit({"phase": "train_fsdp", "arch": MODEL_ARCH, "depth": FSDP_DEPTH,
          "reduced": {"n_layers": [40, FSDP_DEPTH],
                      "why": "qwen1.5-110b at 1 layer (3.85 B parameters, "
                             "~54 GB of state) leaves too little room for two "
                             "ranks' gathers on one card"},
          "train_mode": "fsdp", "seq_len": TRAIN_SEQ, "rows": FSDP_ROWS,
          "micro": FSDP_MICRO, "weights": FSDP_WEIGHTS,
          "mesh": [FSDP_RANKS, 1], "zero1_arch": TRAIN_ARCH,
          "zero1_depth": DIST_DEPTH, "backend": "gloo",
          "why_gloo": "NCCL refuses two ranks on one GPU",
          "ranks_detail": ranks, "held": held, "ranks_wall_s": wall,
          "card_peak_used_gb": card_peak,
          "tolerances": {"loss": TP_LOSS_TOL, "grad_norm": TP_GNORM_TOL,
                         "param_share": TP_PARAM_SHARE, "zero1": ZERO1_TOL},
          "flash_launches": launches, "nvidia_smi": smi})
    if not (held["ok"] and fsdp_ok and zero1_ok):
        raise AssertionError(f"train_fsdp failed: held {held['ok']}, fsdp "
                             f"{fsdp_ok}, zero1 {zero1_ok}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------- #
# The sequence-parallel residual stream
# ---------------------------------------------------------------------- #
# train_sp: SP_SHARDS gloo ranks share cuda:0 (D 1 x M 2), both at once:
# the sharded fsdp step on train_fsdp's cell (glm4-9b at full width and
# FSDP_DEPTH layer in fsdp mode, FSDP_ROWS rows of 8192 positions in
# FSDP_MICRO microbatches, 2 rows a microbatch on each rank, FSDP_WEIGHTS,
# FSDP_STEPS steps, bf16) from the same draw twice: without the
# reference's sequence-parallel residual stream and with act_shard_axis
# "model" (each rank keeps its 4096 of the 8192 positions between
# sublayers). Held: the two runs' losses, gradient norms and parameters
# by TP_LOSS_TOL, TP_GNORM_TOL and params_held's two-ulp rule (bitwise
# expected: at M 2 the reduce-scatter adds the same two fp32 partials as
# the all-reduce, and in bf16 the norm reads its input through one cast,
# so a residual's gradient sums the same two terms); both ranks the same
# losses; flash launches 2 x layers x micro-steps a run on the local heads
# (2, 16, 8192, 128) hk 1; the axis run's model-group bytes a step and its
# peak against launch.dryrun's trace of the cell on a fake 1 x 2 group.
# Reckoning (that trace on the host, meta tensors): a rank rests at 7.23 GB
# (0.72 B parameters: 1.45 GB of bf16 weights, 5.78 GB of fp32 moments)
# and peaks at 16.43 GB without the axis, 16.30 GB with it, in the
# attention backward's fp32 recompute; the axis keeps 1/2 of the two
# residual boundaries a layer autograd holds (2 x 134 MB less 2 x 67 MB).
# Two ranks: ~33 GB of the card. Model-group bytes a step: 3.22 GB
# without the axis, 5.37 GB with it (two gathers and a reduce-scatter a
# sublayer and the backward's gathers replace one all-reduce each way).
SP_SHARDS = 2
SP_FLASH_SHAPE = [[FSDP_ROWS // FSDP_MICRO, 32 // SP_SHARDS, TRAIN_SEQ, 128],
                  1]


def _sp_cfg(axis):
    import dataclasses

    return dataclasses.replace(_fsdp_cfg(), act_shard_axis=axis)


def _sp_rank_body(rank, dev):
    """train_sp's two runs on this rank (without the axis, then with it)
    and the second held to the first on this rank's cut."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch.mesh import make_worker_mesh, model_group
    from repro_torch.models import attention, build_model
    from repro_torch.models.parallel import ModelShards
    from repro_torch.models.transformer import tree_leaves, tree_map
    from repro_torch.runtime.trainstep import make_fsdp_train_step

    group = model_group(make_worker_mesh(1, SP_SHARDS, device_type="cuda"))
    res, params = {"rank": rank}, {}
    shapes, flash = set(), attention._flash

    def spy(q, k, v, causal, window):
        shapes.add((tuple(q.transpose(1, 2).shape), k.shape[2]))
        return flash(q, k, v, causal, window)

    for axis in ("", "model"):
        cfg = _sp_cfg(axis)
        shards = ModelShards(group, SP_SHARDS, rank)
        bundle = build_model(cfg, device=dev, shards=shards)
        step = make_fsdp_train_step(bundle, FSDP_MICRO, donate=True)
        p = bundle.init(torch.Generator(device=dev).manual_seed(0))
        opt = _zero1_moments(cfg, dev, 1, 0, shards)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        shapes.clear()
        attention._flash = spy
        before = flash_attention_cuda.launches
        p, out = _fsdp_steps(step, p, opt, dev, group)
        attention._flash = flash
        res[axis or "none"] = dict(
            out, flash_launches=flash_attention_cuda.launches - before,
            flash_shapes=sorted([list(q), hk] for q, hk in shapes),
            micro_steps=FSDP_MICRO * FSDP_STEPS,
            attention_layers=attention_layer_count(cfg),
            peak_bytes=torch.cuda.max_memory_allocated(dev),
            model_bytes_per_step=shards.stats["bytes"] / FSDP_STEPS)
        params[axis] = tree_map(lambda t: t.cpu(), p)  # off the card
        del p, opt, step, bundle
    on, off = res["model"], res["none"]
    res["bitwise"] = (on["loss"] == off["loss"]
                      and on["grad_norm"] == off["grad_norm"]
                      and all(torch.equal(a, b) for a, b in zip(
                          tree_leaves(params["model"]),
                          tree_leaves(params[""]))))
    errs = {k: max(abs(a - b) / abs(b) for a, b in zip(on[k], off[k]))
            for k in ("loss", "grad_norm")}
    held = params_held(params["model"], params[""], FSDP_STEPS, dev)
    res["held"] = dict(held, err=errs, ok=bool(
        held["ok"] and errs["loss"] <= TP_LOSS_TOL
        and errs["grad_norm"] <= TP_GNORM_TOL))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_train_sp(dev, smi):
    """train_sp (see SP_SHARDS): the two runs on SP_SHARDS gloo ranks on
    cuda:0, then the axis run's cell traced by ``launch.dryrun`` on a fake
    1 x 2 group. Returns the ranks' flash launches (summed)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshSpec

    ranks, wall, card_peak = _ranks_on_card(_sp_rank_body, SP_SHARDS,
                                            "train_sp")
    t0 = time.perf_counter()
    res = dryrun.trace_fsdp(_sp_cfg("model"), MeshSpec(
        (1, SP_SHARDS), ("data", "model")), FSDP_MICRO, FSDP_ROWS, TRAIN_SEQ,
        FSDP_WEIGHTS)
    cost = res["cost"]
    pred = {"peak_bytes": max(cost.peak_bytes, res["argument_bytes"]),
            "model_bytes_per_step":
                cost.groups[res["group_names"]["model"]]["bytes"],
            "trace_s": time.perf_counter() - t0}
    checks = {"held": all(r["held"]["ok"] for r in ranks),
              "ranks_agree": all(
                  r[a]["loss"] == ranks[0][a]["loss"]
                  for r in ranks for a in ("none", "model")),
              "launches": all(
                  r[a]["flash_launches"] == 2 * r[a]["attention_layers"]
                  * r[a]["micro_steps"]
                  and r[a]["flash_shapes"] == [SP_FLASH_SHAPE]
                  for r in ranks for a in ("none", "model")),
              "model_bytes": all(
                  r["model"]["model_bytes_per_step"]
                  == pred["model_bytes_per_step"] for r in ranks),
              "peak": all(
                  abs(pred["peak_bytes"] - r["model"]["peak_bytes"])
                  <= DRYRUN_PEAK_TOL * r["model"]["peak_bytes"]
                  for r in ranks)}
    launches = sum(r[a]["flash_launches"] for r in ranks
                   for a in ("none", "model"))
    emit({"phase": "train_sp", "arch": MODEL_ARCH, "depth": FSDP_DEPTH,
          "reduced": {"n_layers": [40, FSDP_DEPTH]}, "train_mode": "fsdp",
          "seq_len": TRAIN_SEQ, "rows": FSDP_ROWS, "micro": FSDP_MICRO,
          "steps": FSDP_STEPS, "mesh": [1, SP_SHARDS], "backend": "gloo",
          "why_gloo": "NCCL refuses two ranks on one GPU",
          "ranks_detail": ranks, "predicted": pred,
          "bitwise": all(r["bitwise"] for r in ranks), "checks": checks,
          "ranks_wall_s": wall, "card_peak_used_gb": card_peak,
          "tolerances": {"loss": TP_LOSS_TOL, "grad_norm": TP_GNORM_TOL,
                         "param_share": TP_PARAM_SHARE,
                         "peak": DRYRUN_PEAK_TOL},
          "flash_launches": launches, "nvidia_smi": smi})
    if not all(checks.values()):
        raise AssertionError(f"train_sp failed: {checks}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------- #
# Serving over model shards
# ---------------------------------------------------------------------- #
# serve_tp: SERVE_SHARDS gloo ranks share cuda:0 (D 1 x M 2; NCCL refuses
# two ranks on one GPU), the weights cut by the sharding rules, the caches
# by cache_shardings. Each cell of SERVE_TP_CELLS (arch, layers, dtype) at full
# width: a PROMPT_LEN-token prompt, then SERVE_STEPS decode steps
# teacher-forced with the one-process run's greedy tokens (the one-process
# run goes first, in this process, on the same card), held by these rules:
#   * every logit within SERVE_LOGIT_TOL[dtype] x the step's max|logit| of
#     one card (bf16: each rank's partial product rounds once to bf16
#     before the fp32 sum, as for the TP_* tolerances; fp32: the sum
#     order);
#   * the sharded run's greedy token equals one card's at every step where
#     one card's top-2 margin exceeds 2 x that bound;
#   * where layer 0 is an attention layer (not recurrentgemma-2b's rglru),
#     its K/V cache cut within SERVE_KV_ULPS bf16 ulps of one card's: 2^-7
#     of the leaf's largest |value| (the repo's "two bf16 ulps", as
#     params_held's tol);
#   * in every cell, the first attention layer's K/V cut (recurrentgemma-
#     2b's layer 2, a 2048-slot ring buffer cut on slots) within
#     SERVE_KV_ULPS of one card's K/V of that layer computed from the input
#     this rank gave it, so the rule holds the cut itself whatever the
#     layers before it added to that input (their share is reported as
#     kv_input_ulps, and the whole difference from one card as kv_ulps);
#   * exactly one flash launch per attention layer per rank, on the local
#     heads (glm4-9b (1, 16, 8192, 128) hk 1; recurrentgemma-2b's 10 heads
#     (1, 5, 8192, 256) hk 1).
SERVE_SHARDS, SERVE_STEPS, SERVE_SEED = 2, 16, 0
SERVE_TP_CELLS = ((MODEL_ARCH, 2, "bfloat16"), (MODEL_ARCH, 1, "float32"),
               ("recurrentgemma-2b", 3, "bfloat16"))
SERVE_LOGIT_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
SERVE_KV_ULPS = 2


def serve_cfg(arch, layers, dtype):
    """``arch`` at full width, ``layers`` deep, in ``dtype``, with the
    usec rules for a pure-DP arch (as ``launch.serve`` serves it)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                              param_dtype=dtype)
    if cfg.train_mode == "dp":
        cfg = dataclasses.replace(cfg, train_mode="usec")
    return cfg


def first_attention_layer(cfg) -> int:
    """The index, in the stack's order, of the first attention layer."""
    from repro_torch.models.transformer import stack_layout

    n_rep, extra_kinds = stack_layout(cfg)
    order = list(cfg.layer_pattern) * n_rep + list(extra_kinds)
    return next(i for i, k in enumerate(order) if k in ATTENTION_KINDS)


def serve_run(bundle, params, batch, steps, tokens=None, routes=False,
              keep_input=False, keep_params=False):
    """One served prompt: ``bundle.prefill``, the restage into a cache of
    prompt + ``steps`` positions, and ``steps`` decode steps, step i fed
    ``tokens[:, i]`` ((B, steps): another run's picks ``[:, :steps]``), or
    the run's own greedy picks when None. Returns
    the logits of every step gathered whole over the model group (CPU, fp32,
    (steps + 1, B, V)), the picks, the first attention layer's K/V cut
    (``kv_first``, CPU; with ``keep_input`` also that layer's input, its
    positions and window, with ``keep_params`` its weights as this rank
    holds them, on the card), the seconds of
    the prefill (with its restage) and of the decode loop, the model
    group's bytes in each, the flash launches and local-head shapes of the
    prefill, and with ``routes`` the first MoE layer's routed choices over
    the prompt."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch.serve import prompt_length, restage
    from repro_torch.models import attention, make_cache, moe
    from repro_torch.models.parallel import gather_from_model, over
    from repro_torch.models.transformer import tree_map

    cfg, dev, tp = bundle.cfg, bundle.device, bundle.shards
    b, plen = batch["tokens"].shape[0], prompt_length(batch)
    shapes, routed, first = set(), [], {}
    flash, route = attention._flash, moe.route
    prefill_parts = attention.attention_prefill_parts

    def prefill_spy(p, x, cfg_, positions, window=None, *rest):
        parts, cache = prefill_parts(p, x, cfg_, positions, window, *rest)
        if not first:
            first.update(layer=first_attention_layer(cfg), **{
                n: cache[n].float().cpu() for n in ("k", "v")})
            if keep_input:
                first.update(x=x.cpu(), positions=positions.cpu(),
                             window=window)
            if keep_params:
                first["params"] = tree_map(torch.clone, p)
        return parts, cache

    def spy(q, k, v, causal, window):
        shapes.add((tuple(q.transpose(1, 2).shape), k.shape[2]))
        return flash(q, k, v, causal, window)

    def route_spy(router, xt, cfg_):
        r = route(router, xt, cfg_)
        routed.append(r.idx.cpu())
        return r

    def whole(lg):
        return gather_from_model(lg, over(tp, lg.shape[-1], cfg.vocab_size))

    attention._flash = spy
    attention.attention_prefill_parts = prefill_spy
    if routes:
        moe.route = route_spy
    moved = 0 if tp is None else tp.stats["bytes"]
    before = flash_attention_cuda.launches
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    try:
        with torch.no_grad():
            pre, logits = bundle.prefill(params, batch)
    finally:
        attention._flash, moe.route = flash, route
        attention.attention_prefill_parts = prefill_parts
    launches = flash_attention_cuda.launches - before
    prefill_bytes = 0 if tp is None else tp.stats["bytes"] - moved
    with torch.no_grad():
        cache = make_cache(cfg, b, plen + steps, dev, tp, bundle.data)
        restage(cache, pre, cfg, b, plen, plen + steps, tp)
    torch.cuda.synchronize(dev)
    prefill_s = time.perf_counter() - t0
    del pre
    out = [whole(logits).float().cpu()]
    picks = [torch.argmax(out[0], dim=-1)]
    moved = 0 if tp is None else tp.stats["bytes"]
    t1 = time.perf_counter()
    with torch.no_grad():
        for i in range(steps):
            tok = picks[-1] if tokens is None else tokens[:, i]
            cache, logits = bundle.decode_step(
                params, cache, tok.reshape(b, 1).to(dev), plen + i,
                cache_len=plen + steps)
            out.append(whole(logits).float().cpu())
            picks.append(torch.argmax(out[-1], dim=-1))
    torch.cuda.synchronize(dev)
    decode_s = time.perf_counter() - t1
    decode_bytes = 0 if tp is None else tp.stats["bytes"] - moved
    del cache
    return {"logits": torch.stack(out), "picks": torch.stack(picks, 1),
            "kv_first": first or None, "prefill_s": prefill_s,
            "decode_s": decode_s,
            "model_bytes": {"prefill": prefill_bytes,
                            "decode_step": decode_bytes / max(steps, 1)},
            "flash_launches": launches,
            "flash_shapes": sorted([list(q), hk] for q, hk in shapes),
            "routes": torch.cat(routed) if routed else None}


def bf16_ulps(got, want) -> float:
    """The largest |got - want| in bf16 ulps of ``want``'s largest |value|
    (2^-8 of it: the repo's "two bf16 ulps" is 2^-7 of a leaf's largest,
    as ``params_held``'s ``tol``)."""
    top = float(want.float().abs().max())
    diff = float((got.float() - want.float()).abs().max())
    return diff / (top * 2.0 ** -8) if top else diff


def serve_held(one, run, dtype, kv_one=None, kv_on_input=None) -> dict:
    """A sharded run against the one-card run by the serve_tp rules:
    ``kv_one`` is one card's cut of the first attention layer's K/V
    (held within SERVE_KV_ULPS where that layer is layer 0), and
    ``kv_on_input`` the cut of one card's K/V of that layer computed from
    this rank's own input to it (the cut held within SERVE_KV_ULPS of it,
    whatever the layers before it added to the input)."""
    tol = SERVE_LOGIT_TOL[dtype]
    a, b = run["logits"], one["logits"]
    top = b.abs().amax(dim=-1)                     # (steps + 1, B)
    err = ((a - b).abs().amax(dim=-1) / top)
    two = torch.topk(b, 2, dim=-1).values
    margin = (two[..., 0] - two[..., 1]) / top
    decided = margin > 2 * tol
    same = run["picks"].T == one["picks"].T        # (steps + 1, B)
    out = {"logit_err": err.max().item(), "logit_tol": tol,
           "logit_err_per_step": err.amax(dim=-1).tolist(),
           "decided_steps": int(decided.sum()),
           "greedy_equal_where_decided": bool(same[decided].all()),
           "greedy_equal_all": bool(same.all())}
    ok = out["logit_err"] <= tol and out["greedy_equal_where_decided"]
    kv = run["kv_first"]

    def ulps(want):
        return max(bf16_ulps(kv[n], want[n]) for n in ("k", "v"))

    if kv_one is not None:
        out["kv_layer"] = kv["layer"]
        out["kv_ulps"] = ulps(kv_one)
        if kv["layer"] == 0:
            ok &= out["kv_ulps"] <= SERVE_KV_ULPS
    if kv_on_input is not None:
        out["kv_cut_ulps"] = ulps(kv_on_input)
        out["kv_input_ulps"] = max(bf16_ulps(kv_on_input[n], kv_one[n])
                                   for n in ("k", "v"))
        ok &= out["kv_cut_ulps"] <= SERVE_KV_ULPS
    out["ok"] = bool(ok)
    return out


def _serve_cell_one(dev, cell):
    """The one-process run of a serve_tp cell on ``dev``: its record and
    its greedy picks (the ranks' teacher tokens)."""
    from repro_torch.configs import demo_batch
    from repro_torch.models import build_model

    cfg = serve_cfg(*cell)
    bundle = build_model(cfg, device=dev)
    params = bundle.init(torch.Generator(device=dev).manual_seed(SERVE_SEED))
    batch = demo_batch(cfg, "prefill", MODEL_BATCH, PROMPT_LEN,
                       seed=SERVE_SEED)
    run = serve_run(bundle, params, batch, SERVE_STEPS, keep_params=True)
    del bundle, params
    gc.collect()
    torch.cuda.empty_cache()
    return run


def _serve_tp_rank_body(rank, dev):
    """serve_tp's cells over the 1 x SERVE_SHARDS mesh, teacher-forced with
    the one-process picks the parent saved; each run's tensors saved for
    the parent."""
    from repro_torch.configs import demo_batch
    from repro_torch.launch.mesh import (
        coordinates,
        make_worker_mesh,
        model_group,
    )
    from repro_torch.models import build_model
    from repro_torch.models.parallel import ModelShards, cache_dims

    mesh = make_worker_mesh(1, SERVE_SHARDS, device_type="cuda")
    _, m = coordinates(mesh)
    out = {"rank": rank, "model_index": m, "cells": []}
    base = os.path.join(ROOT, "build", "serve_tp_one")
    for i, cell in enumerate(SERVE_TP_CELLS):
        cfg = serve_cfg(*cell)
        shards = ModelShards(model_group(mesh), SERVE_SHARDS, m)
        bundle = build_model(cfg, device=dev, shards=shards)
        torch.cuda.reset_peak_memory_stats(dev)
        params = bundle.init(torch.Generator(device=dev).manual_seed(
            SERVE_SEED))
        batch = demo_batch(cfg, "prefill", MODEL_BATCH, PROMPT_LEN,
                           seed=SERVE_SEED)
        tokens = torch.load(os.path.join(base, f"picks{i}.pt"))
        run = serve_run(bundle, params, batch, SERVE_STEPS,
                        tokens[:, :SERVE_STEPS], keep_input=True)
        run["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        torch.save(run, os.path.join(base, f"run{i}_rank{rank}.pt"))
        kv_dims = [d for (d, _) in cache_dims(cfg, MODEL_BATCH, PROMPT_LEN,
                                              SERVE_SHARDS)]
        out["cells"].append({
            "cell": list(cell), "flash_launches": run["flash_launches"],
            "flash_shapes": run["flash_shapes"],
            "attention_layers": attention_layer_count(cfg),
            "prefill_s": run["prefill_s"], "decode_s": run["decode_s"],
            "model_bytes": run["model_bytes"], "peak_gb": run["peak_gb"],
            "cache_model_dims": kv_dims})
        del bundle, params, run
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_serve_tp(dev, smi):
    """serve_tp (see SERVE_TP_CELLS): the one-process runs first, then
    SERVE_SHARDS gloo ranks on cuda:0 serve every cell, each held to its
    one-process run. Returns the ranks' flash launches (summed)."""
    import shutil

    base = os.path.join(ROOT, "build", "serve_tp_one")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    ones = []
    for i, cell in enumerate(SERVE_TP_CELLS):
        one = _serve_cell_one(dev, cell)
        torch.save(one["picks"], os.path.join(base, f"picks{i}.pt"))
        ones.append(one)
    ranks, wall, card_peak = _ranks_on_card(_serve_tp_rank_body,
                                            SERVE_SHARDS, "serve_tp")
    cells, ok = [], True
    launches = 0
    for i, cell in enumerate(SERVE_TP_CELLS):
        cfg = serve_cfg(*cell)
        one = ones[i]
        local = [1, cfg.n_heads // SERVE_SHARDS, PROMPT_LEN, cfg.head_dim]
        rec = {"cell": list(cell), "one_card": {
            k: one[k] for k in ("prefill_s", "decode_s", "flash_launches",
                                "flash_shapes")}, "ranks": []}
        for r, rank in enumerate(ranks):
            run = torch.load(os.path.join(base, f"run{i}_rank{r}.pt"))
            mine = rank["cells"][i]
            m = rank["model_index"]
            held = serve_held(one, run, cell[2],
                              _kv_cut(one["kv_first"], cfg, m),
                              _kv_cut(_kv_on_input(one, run, cfg), cfg, m))
            n_attn = mine["attention_layers"]
            flash_ok = (mine["flash_launches"] == n_attn and
                        mine["flash_shapes"] == [[local, 1]])
            held["flash_ok"] = flash_ok
            ok &= held["ok"] and flash_ok
            launches += mine["flash_launches"]
            rec["ranks"].append({**mine, "held": held})
        cells.append(rec)
    emit({"phase": "serve_tp", "mesh": [1, SERVE_SHARDS], "backend": "gloo",
          "why_gloo": "NCCL refuses two ranks on one GPU",
          "prompt_len": PROMPT_LEN, "decode_steps": SERVE_STEPS,
          "reduced": {"n_layers": [[c[0], c[1]] for c in SERVE_TP_CELLS]},
          "cells": cells, "ranks_wall_s": wall,
          "card_peak_used_gb": card_peak,
          "tolerances": {"logit": SERVE_LOGIT_TOL,
                         "kv_bf16_ulps": SERVE_KV_ULPS},
          "flash_launches": launches, "nvidia_smi": smi})
    if not ok:
        raise AssertionError("serve_tp failed: " + json.dumps(
            [[r["held"] for r in c["ranks"]] for c in cells]))
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _kv_on_input(one, run, cfg):
    """One card's K/V (the ring buffer of a windowed layer) of the first
    attention layer, from its weights in the one-card run ``one`` and the
    input a sharded rank gave that layer in ``run``: what the cut should
    hold given the error the layers before it added (CPU, fp32)."""
    from repro_torch.models import attention

    mine, theirs = run["kv_first"], one["kv_first"]
    p = theirs["params"]
    dev = next(iter(p.values())).device
    with torch.no_grad():
        _, cache = attention.attention_prefill_parts(
            p, mine["x"].to(dev), cfg, mine["positions"].to(dev),
            mine["window"])
    return {n: cache[n].float().cpu() for n in ("k", "v")}


def _kv_cut(kv, cfg, m, n=SERVE_SHARDS):
    """One card's K/V (B, S, Hk, hd) of the first attention layer of a
    PROMPT_LEN-token prefill cut as model shard ``m`` of ``n`` holds it (the
    rule for one layer's cache); None where there is none."""
    if kv is None:
        return None
    from repro_torch.models.parallel import (
        ModelShards,
        cache_model_dims,
        own_slice,
    )

    dims = cache_model_dims(cfg, MODEL_BATCH, PROMPT_LEN, n)
    layer = next(c for c in dims["blocks"] + dims["extras"]
                 if c is not None and "k" in c)
    d = layer["k"]
    if d is None:
        return {name: kv[name] for name in ("k", "v")}
    tp = ModelShards(None, n, m)
    return {name: own_slice(kv[name], tp, d) for name in ("k", "v")}


def phase_train_remat(dev, smi):
    """One internvl2-2b training step at full width and REMAT_DEPTH layers
    (loss and gradients of one 8192-position tile of the train cell) under
    plain per-block remat, remat_save_outs and remat_sqrt: losses and
    every gradient bitwise equal; each policy's step time (the second of
    two calls) and peak memory; 2 x layers flash launches each."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import cyclic_placement
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models import build_model
    from repro_torch.runtime.trainstep import value_and_grad

    base = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=REMAT_DEPTH)
    params = build_model(base, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    pipe = TokenPipeline(base, cyclic_placement(4, 4, 2), seq_len=TRAIN_SEQ,
                         tile_samples=1, seed=0)
    batch = {k: torch.as_tensor(v[0, 0], device=dev)
             for k, v in pipe.staged_for_step(0).arrays.items()}
    want, out = None, {}
    for name, policy in REMAT_POLICIES.items():
        bundle = build_model(dataclasses.replace(base, **policy), device=dev)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        walls = []
        before = flash_attention_cuda.launches
        for _ in range(2):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            loss, _, grads = value_and_grad(bundle.loss_fn, params, batch)
            torch.cuda.synchronize(dev)
            walls.append(time.perf_counter() - t0)
        launches = flash_attention_cuda.launches - before
        if want is None:
            want = (loss, grads)
        same = bool(torch.equal(loss, want[0])) and all(
            torch.equal(a, b) for a, b in zip(grads, want[1]))
        out[name] = {"step_s": walls[1], "first_call_s": walls[0],
                     "max_memory_allocated_gb":
                         torch.cuda.max_memory_allocated(dev) / 1e9,
                     "bitwise_equal_to_remat": same,
                     "flash_launches": launches, "loss": float(loss)}
        del grads
    emit({"phase": "train_remat", "arch": TRAIN_ARCH, "depth": REMAT_DEPTH,
          "reduced": {"n_layers": [24, REMAT_DEPTH]}, "seq_len": TRAIN_SEQ,
          "policies": out, "nvidia_smi": smi})
    n_attn = attention_layer_count(base)
    if not all(r["bitwise_equal_to_remat"] and r["flash_launches"]
               == 2 * 2 * n_attn for r in out.values()):
        raise AssertionError(f"train_remat: {out}")
    del want, params
    gc.collect()
    torch.cuda.empty_cache()


# The dry-run's production cells run here (one per train mode, 256 fake
# ranks each, in subprocesses beside the card's runs), and two cells the
# smoke runs for real, dry-run with the same arguments at world 1: the
# trainer's cell (TRAIN_ARGS, one step) and glm4-9b's 8192-token prefill.
# Each of the two: the predicted peak within DRYRUN_PEAK_TOL of the card's
# max_memory_allocated over the same run, and the predicted flops equal to
# FlopCounterMode's count of the run.
DRYRUN_CELLS = (("glm4-9b", "train_4k"), ("qwen1.5-110b", "train_4k"),
                ("stablelm-1.6b", "train_4k"))
DRYRUN_PEAK_TOL = 0.05


def _usec_layout(args):
    """(n workers, t_stage, b_max) the trainer derives from ``args``."""
    from repro_torch.core import USECScheduler, cyclic_placement

    def opt(flag):
        return int(args[args.index(flag) + 1])

    n = opt("--workers")
    placement = cyclic_placement(n, opt("--tiles-per-worker") * n,
                                 opt("--replication"))
    sched = USECScheduler(placement, rows_per_tile=1,
                          initial_speeds=np.ones(n),
                          stragglers=opt("--straggler-tolerance"), gamma=0.5)
    return n, max(len(z) for z in placement.storage_sets()), sched.t_max


def phase_dryrun(dev, smi):
    """``repro_torch.launch.dryrun`` held against the card (see
    DRYRUN_CELLS). Hard checks: the module's H100_HBM_BYTES equals the
    card's total memory; each production cell's status ``ok``; each world-1
    cell's peak and flops as stated. The real runs' launches are
    comparisons, not the main path's."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import demo_batch, get_config
    from repro_torch.launch import dryrun, train
    from repro_torch.models import build_model
    from repro_torch.runtime import executor

    total = torch.cuda.get_device_properties(dev).total_memory
    if total != dryrun.H100_HBM_BYTES:
        raise AssertionError(f"dryrun: the card has {total} bytes, the "
                             f"module says {dryrun.H100_HBM_BYTES}")
    out_dir = os.path.join(ROOT, "build", "dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [(arch, shape, time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "single", "--out", out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=ROOT)) for arch, shape in DRYRUN_CELLS]

    # The trainer's cell, one step, on the card and traced.
    args = TRAIN_ARGS[:TRAIN_ARGS.index("--steps")] + ["--steps", "1"] + \
        TRAIN_ARGS[TRAIN_ARGS.index("--steps") + 2:]
    trips, real_bp = [], executor.block_plan

    def bp_spy(*a, **k):
        bp = real_bp(*a, **k)
        trips.append(int(bp.n_blocks.sum()))
        return bp

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    executor.block_plan = bp_spy
    try:
        with FlopCounterMode(display=False) as fc:
            train.main(args)
    finally:
        executor.block_plan = real_bp
    torch.cuda.synchronize(dev)
    real = {"peak": torch.cuda.max_memory_allocated(dev),
            "flops": fc.get_total_flops(), "micro_steps": trips}
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_ARCH)
    n, t_stage, b_max = _usec_layout(args)
    t0 = time.perf_counter()
    res = dryrun.trace_usec(cfg, None, n, t_stage, b_max, 1, TRAIN_SEQ,
                            zero1=False)
    one, two = (int(c.flops) for c in res["costs"])
    per_trip = (two - one) // n
    flops = sum(one - n * per_trip + t * per_trip for t in trips)
    peak = max(res["setup_peak_bytes"], res["argument_bytes"],
               *(c.peak_bytes for c in res["costs"]))
    train_cell = {"args": args, "real": real, "predicted": {
        "peak": peak, "flops": flops, "flops_per_micro_step": per_trip,
        "trace_s": time.perf_counter() - t0},
        "peak_rel_err": abs(peak - real["peak"]) / real["peak"]}

    # glm4-9b's prefill of model_path: batch 1, PROMPT_LEN tokens.
    pcfg = get_config(MODEL_ARCH)
    bundle = build_model(pcfg, device=dev)
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in demo_batch(
        pcfg, "prefill", MODEL_BATCH, PROMPT_LEN, seed=0).items()}
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        cache, logits = bundle.prefill(params, batch)
    torch.cuda.synchronize(dev)
    real = {"peak": torch.cuda.max_memory_allocated(dev),
            "flops": fc.get_total_flops(),
            "finite": bool(torch.isfinite(logits).all())}
    del bundle, params, batch, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = dryrun.trace_serve(pcfg, "prefill", MODEL_BATCH, PROMPT_LEN)
    cost = res["cost"]
    peak = max(cost.peak_bytes, res["argument_bytes"])
    prefill_cell = {"arch": MODEL_ARCH, "batch": MODEL_BATCH,
                    "prompt_len": PROMPT_LEN, "real": real, "predicted": {
                        "peak": peak, "flops": int(cost.flops),
                        "trace_s": time.perf_counter() - t0},
                    "peak_rel_err": abs(peak - real["peak"]) / real["peak"]}

    cells = []
    for arch, shape, t0, proc in procs:
        log, _ = proc.communicate(timeout=900)
        path = os.path.join(out_dir, f"{arch}__{shape}__single.json")
        rec = {"arch": arch, "shape": shape, "rc": proc.returncode,
               "wall_s": time.perf_counter() - t0, "log": log[-600:]}
        if os.path.exists(path):
            with open(path) as fh:
                got = json.load(fh)
            rec.update({k: got.get(k) for k in (
                "status", "meta", "flops_per_device", "bytes_per_device",
                "collective_bytes_per_device", "collective_groups", "memory",
                "setup_peak_bytes", "hbm_fit", "trace_s", "error")})
        cells.append(rec)
    emit({"phase": "dryrun", "hbm_bytes": total,
          "module_hbm_bytes": dryrun.H100_HBM_BYTES, "production": cells,
          "train_path": train_cell, "model_path_prefill": prefill_cell,
          "peak_tol": DRYRUN_PEAK_TOL, "nvidia_smi": smi})
    bad = [c["arch"] for c in cells if c.get("status") != "ok"
           or c["rc"] != 0]
    for name, cell in (("train_path", train_cell),
                       ("prefill", prefill_cell)):
        if cell["peak_rel_err"] > DRYRUN_PEAK_TOL or \
                cell["predicted"]["flops"] != cell["real"]["flops"]:
            bad.append(name)
    if bad or not prefill_cell["real"]["finite"]:
        raise AssertionError(f"dryrun: {bad}")


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
    # deepseek-moe-16b, recurrentgemma-2b, mamba2-370m, internvl2-2b, then
    # the hubert-xlarge encoder's forward; each drops its weights before
    # the next) ----
    totals["flash_attention"] = 0
    for arch in MODEL_ARCHS + (ENCODER_ARCH,):
        model_launches, bundle, params, batch = phase_model_path(
            dev, counters, smi, arch)
        totals["flash_attention"] += model_launches["flash_attention"]
        if bundle.cfg.decoder:
            phase_model_profile(bundle, params, batch)
        if bundle.cfg.is_moe:
            phase_moe_decode_floor(bundle, params)
        del bundle, params, batch
        gc.collect()
        torch.cuda.empty_cache()
    phase_model_parity(dev)

    # ---- 5b. main path: training (internvl2-2b at full width through
    # launch.train.main), then its checks ----
    trained, train_metrics = phase_train_path(dev, counters, smi)
    totals["flash_attention"] += trained["flash_attention"]
    phase_train_drop_exact(dev, smi)
    phase_train_flash_grad(dev)
    phase_train_parity(dev)
    phase_train_remat(dev, smi)
    # ---- 5b'. the dry-run held against the card ----
    phase_dryrun(dev, smi)
    # ---- 5c. main path: training across 4 ranks ----
    reset_launches(counters)
    totals["flash_attention"] += phase_train_dist(dev, smi, train_metrics)
    # ---- 5d. main path: training over model shards ----
    reset_launches(counters)
    totals["flash_attention"] += phase_train_tp(dev, smi)
    # ---- 5e. main path: parameters and moments cut over data ----
    reset_launches(counters)
    totals["flash_attention"] += phase_train_fsdp(dev, smi)
    # ---- 5e'. main path: the sequence-parallel residual stream ----
    reset_launches(counters)
    totals["flash_attention"] += phase_train_sp(dev, smi)
    # ---- 5f. main path: serving over model shards ----
    reset_launches(counters)
    totals["flash_attention"] += phase_serve_tp(dev, smi)

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
