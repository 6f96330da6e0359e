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
mask second, the reference's op order.

Bound on the H100: memory. The least time is the bytes of the real blocks'
rows, plus W, the plan arrays and the (N, B, br, C) output, over 3.35 TB/s:
at the paper's Sec. V size with S = 0 that is X itself, 144 MB, about 43 us.

Design: the grid is (N * B_max, row groups of 8, column tiles of 8). Each CTA
loads its own slot, offset and trip count (the TPU kernel's scalar prefetch),
and each warp reduces one block row over K in registers. The ragged K tail is
handled in the kernel, so the staged buffer is read in place: the TPU
wrapper's per-call ``jnp.pad`` of the whole buffer (432 MB at Sec. V) is gone.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .ref import segmented_gather_ref

__all__ = ["segmented_plain", "usec_segmented_cuda"]

_INT_MAX = 2 ** 31 - 1


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


def _entry():
    lib = _build.library("usec_segmented")
    fn = lib.usec_segmented_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, i, i, i, p, p, p, p, p, i, p,
                       i, i, i, i, i, p]
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
    arrays int32 / fp32 and contiguous; w cast to fp32. Raises on anything
    the kernel does not take, and on a launch error."""
    if not staged.is_cuda:
        raise ValueError("usec_segmented_cuda needs CUDA tensors; use the "
                         "plain version (mode='ref') for host tensors")
    if staged.ndim != 4 or staged.dtype != torch.float32:
        raise ValueError("staged must be (N, T, rows_per_tile, K) float32, "
                         f"got {tuple(staged.shape)} {staged.dtype}")
    n, t, rpt, k = staged.shape
    if blk_slot.ndim != 2 or blk_slot.shape[0] != n:
        raise ValueError(f"plan arrays must be ({n}, B), got "
                         f"{tuple(blk_slot.shape)}")
    b = blk_slot.shape[1]
    if w.ndim != 2 or w.shape[0] != k:
        raise ValueError(f"w must be ({k}, C), got {tuple(w.shape)}")
    c = w.shape[1]
    if rpt % block_rows:
        raise ValueError(
            f"block_rows={block_rows} must divide rows_per_tile={rpt}")
    w = w.to(torch.float32)
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
    if out is None:
        out = torch.empty((n, b, block_rows, c), dtype=torch.float32,
                          device=staged.device)
    elif (tuple(out.shape) != (n, b, block_rows, c) or not out.is_contiguous()
          or out.dtype != torch.float32 or out.device != staged.device):
        raise ValueError("out must be a contiguous float32 "
                         f"({n}, {b}, {block_rows}, {c}) tensor")
    if out.numel() == 0:
        return out
    if not (k <= 1 or staged.stride(3) == 1) or not (c <= 1
                                                      or w.stride(1) == 1):
        raise ValueError("staged and w need unit column stride")
    if max(staged.stride(0), staged.stride(1), staged.stride(2), n * b, k,
           w.stride(0)) > _INT_MAX:
        raise ValueError("shape or stride exceeds int32")
    if (block_rows + 7) // 8 > 65535 or (c + 7) // 8 > 65535:
        raise ValueError("block_rows or C exceeds the kernel's grid")
    lib, fn = _entry()
    code = fn(
        staged.data_ptr(), staged.stride(0), staged.stride(1),
        staged.stride(2), t, rpt,
        blk_slot.data_ptr(), blk_off.data_ptr(), n_blocks.data_ptr(),
        blk_include.data_ptr(), w.data_ptr(), w.stride(0), out.data_ptr(),
        n, b, block_rows, k, c, _build.stream_handle(staged.device),
    )
    _build.check(lib, code, "usec_segmented launch")
    usec_segmented_cuda.launches += 1
    return out


usec_segmented_cuda.launches = 0
