"""Hopper kernel for the segment-aware executor path: every worker's whole
block list in ONE launch.

Replaces the TPU kernel
:func:`repro.kernels.usec_segmented.usec_segmented_padded` (body
``_segmented_kernel``), which the reference launches once per worker inside
its shard_map. Source: ``csrc/usec_segmented.cu``; plain version:
:func:`segmented_plain` below.

For every worker n and plan block i it computes
``out[n, i] = (staged[n, slot[n, i], off[n, i]:off[n, i] + br] @ W) *
include[n, i]`` and writes zeros for the padding blocks ``i >= n_blocks[n]``
(the reference's zero-trip ``lax.cond``). The product comes first and the
mask second, the reference's op order. Every CTA loads its own slots,
offsets and trip count (the TPU kernel's scalar prefetch). The ragged K tail
is handled in the kernel, so the staged buffer is read in place: the TPU
wrapper's per-call ``jnp.pad`` of the whole buffer is gone.

Two designs, chosen from W's width C by :func:`segmented_route`:

- ``"warp"`` (C = 1, the power iteration): the grid is (N * B_max, row
  groups of 8) and each warp reduces one block row over K in registers.
  Bound on the H100: memory, the real blocks' rows (plus W, the plan arrays
  and the output) once at 3.35 TB/s; at the benchmark's 36000^2 with S = 0
  that is X itself, 5.18 GB, about 1.55 ms.
- ``"tiled"`` (C > 1, the served windows at ``batch_cols`` = 32; counted in
  ``launches_tiled``): a CTA owns 48 consecutive output rows of one worker,
  each gathered through its own block's slot and offset, against 32 columns
  of W, and streams K through a ring of shared-memory stages, so X is read
  from HBM once per call and each W chunk once per 48 rows. Its 4 warps
  split each chunk's K and sum their partial tiles in a fixed order: the
  same bits every run. At 36000^2 and C = 32 the bound is X's bytes (1.55
  ms) over the FFMAs' 82.9 GFLOP (1.24 ms at 67 TFLOP/s).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .ref import segmented_gather_ref

__all__ = ["segmented_plain", "segmented_route", "usec_segmented_cuda"]

_INT_MAX = 2 ** 31 - 1
_TILE_ROWS, _TILE_COLS = 48, 32  # the tiled kernel's CTA tile


def segmented_plain(
    staged: torch.Tensor,
    blk_slot: torch.Tensor,
    blk_off: torch.Tensor,
    blk_include: torch.Tensor,
    n_blocks: torch.Tensor,
    w: torch.Tensor,
    block_rows: int,
) -> torch.Tensor:
    """Plain version of the kernel, on whatever device its inputs lie on.

    staged: (N, T, rows_per_tile, K); blk_slot/blk_off/blk_include: (N, B);
    n_blocks: (N,); w: (K, C). Returns (N, B, block_rows, C) fp32: gathered
    rows times W in one flat matmul (:func:`.ref.segmented_gather_ref`),
    times the include weights, zeros past each worker's trip count.
    """
    n, t, rpt, k = staged.shape
    b = blk_slot.shape[1]
    c = w.shape[1]
    base = torch.arange(n, device=staged.device)[:, None] * t
    y = segmented_gather_ref(
        staged.reshape(n * t, rpt, k),
        (blk_slot.to(torch.int64) + base).reshape(-1),
        blk_off.reshape(-1), w, block_rows)
    y = y.reshape(n, b, block_rows, c) * blk_include[:, :, None, None]
    valid = (torch.arange(b, device=staged.device)[None, :]
             < n_blocks.to(staged.device)[:, None])
    return torch.where(valid[:, :, None, None], y, torch.zeros_like(y))


def segmented_route(c: int) -> str:
    """The kernel that takes a call with ``c`` columns of W: ``"warp"`` for
    one column (a warp per block row; W is one fp32 a K step), ``"tiled"``
    for more (W staged in shared memory once per 48 rows, X read once)."""
    return "warp" if c <= 1 else "tiled"


def _check_args(staged, blk_slot, blk_off, blk_include, n_blocks, w,
                block_rows):
    """The call's shapes ``(n, t, rpt, k, b, c)``; raises ValueError on
    anything the kernels do not take. ``w`` must already be fp32."""
    if staged.ndim != 4 or staged.dtype != torch.float32:
        raise ValueError("staged must be (N, T, rows_per_tile, K) float32, "
                         f"got {tuple(staged.shape)} {staged.dtype}")
    n, t, rpt, k = staged.shape
    if blk_slot.ndim != 2 or blk_slot.shape[0] != n:
        raise ValueError(f"plan arrays must be ({n}, B), got "
                         f"{tuple(blk_slot.shape)}")
    b = blk_slot.shape[1]
    if w.ndim != 2 or w.shape[0] != k or w.dtype != torch.float32:
        raise ValueError(f"w must be ({k}, C) float32, got {tuple(w.shape)} "
                         f"{w.dtype}")
    c = w.shape[1]
    if block_rows < 1 or rpt % block_rows:
        raise ValueError(
            f"block_rows={block_rows} must divide rows_per_tile={rpt}")
    for name, arr, dtype, shape in (
            ("blk_slot", blk_slot, torch.int32, (n, b)),
            ("blk_off", blk_off, torch.int32, (n, b)),
            ("blk_include", blk_include, torch.float32, (n, b)),
            ("n_blocks", n_blocks, torch.int32, (n,))):
        if (arr.dtype != dtype or tuple(arr.shape) != shape
                or not arr.is_contiguous() or arr.device != staged.device):
            raise ValueError(f"{name} must be a contiguous {dtype} {shape} "
                             f"tensor on {staged.device}")
    if w.device != staged.device:
        raise ValueError(f"w on {w.device}, staged on {staged.device}")
    if not (k <= 1 or staged.stride(3) == 1) or not (c <= 1
                                                      or w.stride(1) == 1):
        raise ValueError("staged and w need unit column stride")
    if max(staged.stride(0), staged.stride(1), staged.stride(2), n * b, k,
           w.stride(0), b * block_rows) > _INT_MAX:
        raise ValueError("shape or stride exceeds int32")
    if segmented_route(c) == "tiled":
        tiles = -(-b * block_rows // _TILE_ROWS)
        if n * tiles > _INT_MAX or -(-c // _TILE_COLS) > 65535:
            raise ValueError("N * B * block_rows or C exceeds the tiled "
                             "kernel's grid")
    elif -(-block_rows // 8) > 65535:
        raise ValueError("block_rows exceeds the kernel's grid")
    return n, t, rpt, k, b, c


def _entry():
    lib = _build.library("usec_segmented")
    fn = lib.usec_segmented_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, i, i, i, p, p, p, p, p, i, p,
                       i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib, fn


def usec_segmented_cuda(
    staged: torch.Tensor,
    blk_slot: torch.Tensor,
    blk_off: torch.Tensor,
    blk_include: torch.Tensor,
    n_blocks: torch.Tensor,
    w: torch.Tensor,
    block_rows: int,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the kernel over every worker's block list (shapes as in
    :func:`segmented_plain`). staged fp32 with unit column stride; the plan
    arrays int32 / fp32 and contiguous; w cast to fp32. The kernel is
    :func:`segmented_route`'s for C; ``launches`` counts every call and
    ``launches_tiled`` those on the tiled kernel. Raises on anything the
    kernels do not take, and on a launch error."""
    if not staged.is_cuda:
        raise ValueError("usec_segmented_cuda needs CUDA tensors; use the "
                         "plain version (mode='ref') for host tensors")
    w = w.to(torch.float32)
    n, t, rpt, k, b, c = _check_args(staged, blk_slot, blk_off, blk_include,
                                     n_blocks, w, block_rows)
    if out is None:
        out = torch.empty((n, b, block_rows, c), dtype=torch.float32,
                          device=staged.device)
    elif (tuple(out.shape) != (n, b, block_rows, c) or not out.is_contiguous()
          or out.dtype != torch.float32 or out.device != staged.device):
        raise ValueError("out must be a contiguous float32 "
                         f"({n}, {b}, {block_rows}, {c}) tensor")
    if out.numel() == 0:
        return out
    tiled = segmented_route(c) == "tiled"
    lib, fn = _entry()
    code = fn(
        staged.data_ptr(), staged.stride(0), staged.stride(1),
        staged.stride(2), t, rpt,
        blk_slot.data_ptr(), blk_off.data_ptr(), n_blocks.data_ptr(),
        blk_include.data_ptr(), w.data_ptr(), w.stride(0), out.data_ptr(),
        n, b, block_rows, k, c, int(tiled),
        _build.stream_handle(staged.device),
    )
    _build.check(lib, code, "usec_segmented launch")
    usec_segmented_cuda.launches += 1
    usec_segmented_cuda.launches_tiled += int(tiled)
    return out


usec_segmented_cuda.launches = 0
usec_segmented_cuda.launches_tiled = 0
