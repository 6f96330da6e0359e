#!/usr/bin/env python3
"""Does torch.profiler's trace keep every kernel record late in a process?

Run from the repository root on a CUDA card:  python3 trace_probe.py

``chip_smoke.py`` times each kernel from the profiler's CUPTI trace of a
few back-to-back calls. Late in a long process such a trace can miss some
of the calls' kernel records, which reads as a time below the kernel's
bound. This script traces 10 calls of the glm4-9b flash layer (the
tensor-core kernel) and 10 of SDPA after each of a series of workloads and
prints how many records of each the trace kept: fresh; after 120,000 eager
``usec_matvec`` launches; after 40 captured CUDA graphs; then after Sec. V
engine runs (6000^2, cyclic, N = 6, J = 3) without and with the integrity
checker (``verify_results``), and after freeing everything. One JSON line
per stage; the card's name and power limit first.
"""

import gc
import json
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

import chip_smoke as cs

CALLS = 10


def kept(fns) -> dict:
    """Records the trace kept of ``CALLS`` calls of each function: the
    count of its most expensive device entry."""
    out = {}
    for name, fn in fns.items():
        t = cs.device_times(fn, CALLS)
        out[name] = max(t.values())[1] if t else 0
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("trace_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.faults import ChaosPlan, FaultSpec
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.usec_matvec import usec_matvec_cuda
    from repro_torch.runtime import make_exact_matrix

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda", 0)
    q, k, v = cs.flash_operands(cs.FLASH_LAYER, dev, 99)
    fns = {"flash": lambda: flash_attention_cuda(q, k, v, causal=True),
           "sdpa": lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=True, enable_gqa=True)}

    def stage(name, seconds=0.0):
        print(json.dumps({"stage": name, "calls": CALLS, "kept": kept(fns),
                          "stage_s": seconds}), flush=True)

    stage("fresh")
    x = torch.randn(cs.BLOCK_ROWS, cs.DIM, device=dev)
    w = torch.randn(cs.DIM, 1, device=dev)
    out = torch.empty(cs.BLOCK_ROWS, 1, device=dev)
    t0 = time.perf_counter()
    for _ in range(120_000):
        usec_matvec_cuda(x, w, out=out)
    torch.cuda.synchronize()
    stage("after 120000 eager usec_matvec launches", time.perf_counter() - t0)

    t0 = time.perf_counter()
    graphs = []
    for _ in range(40):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            usec_matvec_cuda(x, w, out=out)
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            usec_matvec_cuda(x, w, out=out)
        g.replay()
        graphs.append(g)
    torch.cuda.synchronize()
    stage("after 40 captured graphs", time.perf_counter() - t0)
    del graphs

    xs = make_exact_matrix(cs.DIM, 0)

    def runs(n, seg, arrival, fuse, cfg=None, faults=()):
        t0 = time.perf_counter()
        for _ in range(n):
            gc.collect()
            plan = ChaosPlan([FaultSpec(*f) for f in faults]) if faults \
                else None
            cs.power_iteration(
                None, xs, "cyclic", cs.REPLICATION, 1, seg, cs.N_WORKERS,
                cs.BASE_SPEEDS, cs.SCRIPT, cs.STEPS, cs.BLOCK_ROWS,
                arrival=arrival, fuse_steps=fuse, inject=False, faults=plan,
                cfg=cfg)
        return time.perf_counter() - t0

    stage("after 4 segmented runs, checker off",
          runs(4, "auto", "barrier", 1))
    stage("after 4 segmented runs, verify_results=always",
          runs(4, "auto", "barrier", 1, {"verify_results": "always"}))
    stage("after 4 fused (first, 4) runs, verify_results=sample",
          runs(4, "auto", "first", 4, {"verify_results": "sample"}))
    stage("after 2 tile corruptions, verify_results=sample",
          runs(2, "auto", "barrier", 1, {"verify_results": "sample"},
               [("tile_corruption", 4, 1)]))
    stage("after 3 per-block runs, verify_results=always",
          runs(3, None, "barrier", 1, {"verify_results": "always"}))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    stage("after gc.collect and empty_cache")
    return 0


if __name__ == "__main__":
    sys.exit(main())
