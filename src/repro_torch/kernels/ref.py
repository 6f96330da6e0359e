"""Plain PyTorch versions of the port's kernels.

Each function here computes what a hand-written kernel computes, with
library operations on whatever device its inputs lie on, accumulating in
fp32. The CPU wrappers of :mod:`repro_torch.kernels.ops` run them, the tests
hold them against the JAX package's oracles, and ``chip_smoke.py`` holds each
kernel against them on the card. Twins of :mod:`repro.kernels.ref` and
:mod:`repro.kernels.usec_segmented`.
"""

from __future__ import annotations

import torch


def matvec_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y = X @ w with fp32 accumulation. x: (m, k); w: (k,) or (k, c)."""
    squeeze = w.ndim == 1
    w2 = w[:, None] if squeeze else w
    y = x.to(torch.float32) @ w2.to(torch.float32)
    return y[:, 0] if squeeze else y


def gather_block_rows(
    staged: torch.Tensor,
    blk_slot: torch.Tensor,
    blk_off: torch.Tensor,
    block_rows: int,
) -> torch.Tensor:
    """Gather a block list's rows out of the staged tile buffer.

    staged: (T, rows_per_tile, K); blk_slot/blk_off: (B,) plan indices
    (offsets in rows). Returns (B, block_rows, K).
    """
    t, rpt, k = staged.shape
    b = blk_slot.shape[0]
    flat = staged.reshape(t * rpt, k)
    rows = (
        blk_slot.to(torch.int64) * rpt + blk_off.to(torch.int64)
    )[:, None] + torch.arange(block_rows, device=staged.device)[None, :]
    return flat[rows.reshape(-1)].reshape(b, block_rows, k)


def segmented_gather_ref(
    staged: torch.Tensor,
    blk_slot: torch.Tensor,
    blk_off: torch.Tensor,
    w: torch.Tensor,
    block_rows: int,
) -> torch.Tensor:
    """Gather all block rows, then one flat fp32 matmul: (B, block_rows, C).

    Accumulation order over K may differ from a per-block loop in the last
    ulp on non-exact data; on integer-grid matrices every partial sum is
    exactly representable and all paths agree bitwise.
    """
    b = blk_slot.shape[0]
    xg = gather_block_rows(staged, blk_slot, blk_off, block_rows)
    y = xg.reshape(b * block_rows, -1).to(torch.float32) @ w.to(torch.float32)
    return y.reshape(b, block_rows, w.shape[1])
