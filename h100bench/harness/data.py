"""Inputs made from the seed: the matrix X, job iterates, served operands.

X is the paper's exactness construction (``make_exact_matrix`` of the
program, rebuilt here from its description, not imported): ``a + a.T`` with
``a`` uniform on the integers ``[lo, hi]``, plus ``diag`` on the diagonal.
It is drawn on the device with a ``torch.Generator`` in a few large calls,
so the same seed gives the same X on every run and on both sides.
"""

from __future__ import annotations

import numpy as np
import torch

# Streams of one run's seed: each input gets its own, so adding one never
# shifts another.
STREAM_MATRIX = 0
STREAM_OPERANDS = 1
STREAM_CHURN = 2
STREAM_CLOCK = 3
STREAM_STRAGGLERS = 4
STREAM_ARRIVALS = 5


def rng(seed: int, stream: int) -> np.random.Generator:
    """The host generator of one input stream of ``seed``."""
    return np.random.default_rng([int(seed), int(stream)])


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for a library that takes one integer."""
    return int(rng(seed, stream).integers(0, 2 ** 63 - 1))


def make_matrix(cfg: dict, seed: int, device, dtype=torch.float32
                ) -> torch.Tensor:
    """X (D, D) on ``device`` in ``dtype``: symmetric, integer-valued."""
    m = cfg["matrix"]
    d = int(cfg["matrix_size"])
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, STREAM_MATRIX))
    a = torch.randint(int(m["lo"]), int(m["hi"]) + 1, (d, d), generator=gen,
                      device=device, dtype=torch.int8)
    x = a.to(dtype)
    x.add_(a.t())
    del a
    x.diagonal().add_(float(m["diag"]))
    return x


def job_operands(seed: int, n_jobs: int, dim: int, first: int = 0
                 ) -> np.ndarray:
    """(n_jobs, dim) float32 starting vectors of jobs ``first``, ... (the
    program normalizes and snaps each to its grid, as the reference
    does)."""
    out = np.empty((n_jobs, dim), dtype=np.float32)
    for j in range(n_jobs):
        r = np.random.default_rng([int(seed), STREAM_OPERANDS, first + j])
        out[j] = r.standard_normal(dim, dtype=np.float32)
    return out
