"""The plain reference: what every output of a timed window must equal.

Plain PyTorch, no kernel and nothing of the program. It works the answers
out again from the inputs the benchmark made (X from the seed, the jobs'
starting vectors, the served operands) and never reads the program's
weights, plans or state; the program's outputs come in only to be judged.

The products run in float64 on the card. With the exactness construction
(X on the 2^-6 grid, iterates on the 2^-8 grid) every product and partial
sum is exact in float64, and in float32 too, which is what the program
computes in. So the comparison of ``y`` is exact (limit 0). X's diagonal
has 12 significant bits, one more than TF32 keeps, so a product in TF32 is
not exact.

``quantize_unit`` is a frozen copy of the paper's power-iteration update
(normalize by a sum of squares taken in a fixed binary tree, snap to the
2^-bits grid), here for a batch of columns at once: every column goes
through the same elementwise IEEE float32 schedule as the program's 1-d
host version, so the bits agree.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def tree_sumsq(v: torch.Tensor) -> torch.Tensor:
    """Column sums of squares of (D, C) ``v`` by a binary tree of adds:
    square, zero-pad D to a power of two, add the even and odd halves until
    one row is left."""
    s = v * v
    n = 1
    while n < s.shape[0]:
        n *= 2
    if n != s.shape[0]:
        s = torch.cat([s, s.new_zeros((n - s.shape[0],) + s.shape[1:])])
    while s.shape[0] > 1:
        s = s[0::2] + s[1::2]
    return s[0]


def quantize_unit(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Columns of (D, C) ``v`` normalized in float32 and snapped to the
    2^-bits grid; a column that snaps to all zeros becomes the unit vector
    at its largest |entry|."""
    v = v.to(torch.float32)
    u = v / torch.sqrt(tree_sumsq(v))
    q = (torch.round(u * (1 << bits)) / float(1 << bits)).to(torch.float32)
    dead = ~torch.any(q != 0, dim=0)
    if bool(dead.any()):
        hot = torch.zeros_like(q)
        hot[torch.argmax(torch.abs(v), dim=0), torch.arange(v.shape[1])] = 1.0
        q = torch.where(dead[None, :], hot, q)
    return q


def power_iteration(x: torch.Tensor, w0: torch.Tensor, steps: int,
                    bits: int, matmul=None) -> Dict[str, List[torch.Tensor]]:
    """Every job at once: ``w0`` (D, J) starting vectors, ``steps``
    iterations each. Returns per step ``y`` (D, J) float64, the Rayleigh
    quotient and the residual ``||y - lambda w|| / ||y||`` (J,), and the
    final iterate (D, J) float32. ``matmul(x, w)`` replaces the float64
    product (the control's lower precision); its result is widened to
    float64."""
    w = quantize_unit(w0, bits)
    ys, lams, res = [], [], []
    for _ in range(steps):
        w64 = w.to(torch.float64)
        if matmul is None:
            y = x @ w64
        else:
            y = matmul(x, w).to(torch.float64)
        lam = (w64 * y).sum(0) / (w64 * w64).sum(0)
        num = torch.linalg.vector_norm(y - lam[None, :] * w64, dim=0)
        den = torch.linalg.vector_norm(y, dim=0)
        den = torch.where(den == 0, torch.ones_like(den), den)
        ys.append(y)
        lams.append(lam)
        res.append(num / den)
        w = quantize_unit(y, bits)
    return {"y": ys, "eigval": lams, "residual": res, "eigvec": w}


def answers(x: torch.Tensor, operands: torch.Tensor, matmul=None
            ) -> torch.Tensor:
    """``X @ W`` for the (D, P) served operand pool, in float64 (or
    ``matmul``'s precision, widened)."""
    if matmul is None:
        return x @ operands.to(torch.float64)
    return matmul(x, operands).to(torch.float64)


def to_tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 ``v`` rounded to TF32 (10 stored mantissa bits, to nearest,
    ties to even), kept in float32."""
    u = v.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    u = u & 0xFFFFFFFF
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u)
    return u.to(torch.int32).view(torch.float32)


def tf32_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The control: the product in TF32, the precision below the
    configurations' float32 that a later change would be tempted by:
    operands rounded to TF32, products summed in float32 (as the tensor
    cores do), on the CPU as on the card."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return to_tf32(x) @ to_tf32(w)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def bf16_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A coarser control: bfloat16 operands and result."""
    return x.to(torch.bfloat16) @ w.to(torch.bfloat16)


CONTROLS = {"tf32": tf32_matmul, "bf16": bf16_matmul}


def rel_gap(a: np.ndarray, b: np.ndarray) -> float:
    """max |a - b| / max(|b|, tiny), elementwise over matching arrays."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def max_abs_gap(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b))) if a.size else 0.0
