"""Shared helpers of the benchmark's own tests: the checkout and ``src`` on
``sys.path``, and cells cut to a size the CPU runs in a second."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_DIM = 1200   # divides into the 200-row cyclic and 60-row MAN tiles


def tiny(name: str, dim: int = TINY_DIM):
    """The cell ``name`` with X cut to ``dim`` and a short warm-up."""
    from h100bench.harness import bench

    c = bench.cell(name)
    c = copy.deepcopy(c)
    c.cfg["matrix_size"] = dim
    if "warmup_jobs" in c.traffic:
        c.traffic["warmup_jobs"] = 1
    if "warmup_windows" in c.traffic:
        c.traffic["warmup_windows"] = 1
        c.traffic["rate_per_s"] = 40.0
    return c


@pytest.fixture
def run_tiny():
    """``run_tiny(name, seed, seconds, trace)``: one run's result object
    on the CPU (the harness's look for a card skipped)."""
    import time

    import torch

    from h100bench.harness import bench, main

    def go(name, seed=2 ** 31 + 7, seconds=0.4, trace=False, cell=None):
        cell = cell or tiny(name)
        return main.execute(cell, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter(), bench.benchmark(),
                            log=lambda s: None)

    return go


@pytest.fixture
def card():
    """The first CUDA device; skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
