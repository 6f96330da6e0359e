"""Plain PyTorch versions of the port's kernels.

Each function here computes what a hand-written kernel computes, with
library operations on whatever device its inputs lie on, accumulating in
fp32. The CPU wrappers of :mod:`repro_torch.kernels.ops` run them, the tests
hold them against the JAX package's oracles, and ``chip_smoke.py`` holds each
kernel against them on the card. Twins of :mod:`repro.kernels.ref` and
:mod:`repro.kernels.usec_segmented`.
"""

from __future__ import annotations

from typing import Optional

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


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Softmax attention oracle, materializing the full score matrix.

    q: (b, h, sq, d); k/v: (b, h, skv, d). With ``causal``, query i attends to
    keys j <= i + (skv - sq) (aligned to the *end* of the KV sequence, the
    decode convention). ``window`` additionally restricts each query to the
    trailing ``window`` keys. Masked scores are ``-inf``, so a query with no
    live key gives NaN. Returns (b, h, sq, d) in q's dtype.
    """
    sq, d = q.shape[2], q.shape[3]
    skv = k.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask[None, None], s, float("-inf"))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.to(torch.float32))
    return o.to(q.dtype)
