"""Public wrappers around the port's kernels, with dispatch by device.

Twins of :mod:`repro.kernels.ops`. The route is picked per call:

  * ``mode=None`` / ``"auto"``: by the tensor's device. A CUDA tensor goes to
    the hand-written kernel, a CPU tensor to the plain PyTorch version.
  * ``"cuda"``: the kernel, always (it raises on a CPU tensor).
  * ``"ref"``: the plain version, on any device.

There is no fallback: a CUDA tensor launches the kernel or the call raises.
The reference's ``"pallas"`` and ``"interpret"`` modes do not exist here and
raise ``ValueError``.

Flash attention goes through the operator ``torch.ops.repro_torch.
flash_attention`` (``kernels.flash_attention.flash_attention_op``): on a
CUDA tensor it is the kernel; on a meta tensor (the dry-run's stand-in for
a card tensor, :mod:`repro_torch.launch.dryrun`) its fake implementation
gives the output's shape and runs nothing.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from .flash_attention import flash_attention_op, flash_attention_plain
from .ref import matvec_ref, segmented_gather_ref
from .tile_checksum import tile_checksum_cuda, tile_checksum_plain
from .usec_matvec import usec_matvec_cuda
from .usec_segmented import segmented_plain, usec_segmented_cuda

MODES = (None, "auto", "cuda", "ref")


def check_mode(mode: Optional[str]) -> None:
    """Raise ValueError unless ``mode`` names one of the port's routes."""
    if mode not in MODES:
        raise ValueError(
            f"mode must be one of {MODES} (the port's routes: by device, the "
            f"CUDA kernel, or the plain PyTorch version), got {mode!r}")


def use_kernel(mode: Optional[str], x: torch.Tensor) -> bool:
    """True when a call with ``mode`` on tensor ``x`` takes the kernel."""
    check_mode(mode)
    if mode == "ref":
        return False
    return mode == "cuda" or x.is_cuda


def card_route(mode: Optional[str], x: torch.Tensor) -> bool:
    """:func:`use_kernel` for the flash operator, which also takes a meta
    tensor (the dry-run's stand-in for a card tensor) on the card's route
    unless ``mode`` is ``"ref"``."""
    return use_kernel(mode, x) or (x.is_meta and mode != "ref")


def usec_matvec(
    x: torch.Tensor,
    w: torch.Tensor,
    mode: Optional[str] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """y = X @ w (fp32 accumulate). x: (m, k); w: (k,) or (k, c).

    ``out`` (the result's shape, fp32) receives the result in place.
    """
    squeeze = w.ndim == 1
    w2 = w[:, None] if squeeze else w
    out2 = None if out is None else (out[:, None] if squeeze else out)
    if use_kernel(mode, x):
        y = usec_matvec_cuda(x, w2, out=out2)
    else:
        y = matvec_ref(x, w2)
        if out2 is not None:
            y = out2.copy_(y)
    return y[:, 0] if squeeze else y


def usec_matmat(
    x: torch.Tensor,
    w: torch.Tensor,
    block_n: int = 128,
    mode: Optional[str] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Y = X @ W for multi-column W (fp32 accumulate). x: (m, k); w: (k, c).

    On the kernel route W's columns go through in ``block_n`` chunks, one
    launch each, written into column slices of one output; a 1-d ``w`` or
    ``c <= block_n`` is exactly :func:`usec_matvec`.
    """
    if w.ndim == 1 or w.shape[1] <= block_n or not use_kernel(mode, x):
        return usec_matvec(x, w, mode=mode, out=out)
    m, c = x.shape[0], w.shape[1]
    if out is None:
        out = torch.empty((m, c), dtype=torch.float32, device=x.device)
    for j in range(0, c, block_n):
        usec_matvec_cuda(x, w[:, j: j + block_n], out=out[:, j: j + block_n])
    return out


def usec_segmented(
    staged: torch.Tensor,
    blk_slot: torch.Tensor,
    blk_off: torch.Tensor,
    blk_include: torch.Tensor,
    w: torch.Tensor,
    block_rows: int,
    n_blocks: Optional[torch.Tensor] = None,
    mode: Optional[str] = None,
) -> torch.Tensor:
    """Block lists in one shot: per-block partials, include weights applied.

    One worker, as the reference: staged (T, rows_per_tile, K) with (B,)
    plan arrays gives (B, block_rows, c). Every worker at once: staged
    (N, T, rows_per_tile, K) with (N, B) plan arrays and ``n_blocks`` (N,)
    gives (N, B, block_rows, c), zeros past each worker's trip count. Offsets
    are in rows; plans are compiled with ``row_align == block_rows``.
    ``n_blocks=None`` means every block is real.
    """
    single = staged.ndim == 3
    if single:
        staged = staged[None]
        blk_slot, blk_off = blk_slot[None], blk_off[None]
        blk_include = blk_include[None]
    n, b = blk_slot.shape
    if staged.shape[2] % block_rows:
        raise ValueError(
            f"block_rows={block_rows} must divide rows_per_tile="
            f"{staged.shape[2]}")
    if n_blocks is None:
        n_blocks = torch.full((n,), b, dtype=torch.int32,
                              device=blk_slot.device)
    if use_kernel(mode, staged):
        dev = staged.device
        out = usec_segmented_cuda(
            staged, blk_slot.to(dev, torch.int32).contiguous(),
            blk_off.to(dev, torch.int32).contiguous(),
            blk_include.to(dev, torch.float32).contiguous(),
            n_blocks.to(dev, torch.int32).contiguous(), w, block_rows)
    else:
        out = segmented_plain(staged, blk_slot, blk_off, blk_include,
                              n_blocks, w, block_rows)
    return out[0] if single else out


_EXECUTOR_KERNELS = {
    "matvec": usec_matvec,
    "matmat": usec_matmat,
}


def executor_matmul(mode: Optional[str] = None, workload: str = "matvec"):
    """Block-level matmul ``f(xb, w2, out=None)`` for the executor's
    per-block path, routed through the per-workload kernel table
    (``"matvec"`` -> :func:`usec_matvec`, ``"matmat"`` -> the blocked
    :func:`usec_matmat`)."""
    try:
        kernel = _EXECUTOR_KERNELS[workload]
    except KeyError:
        raise ValueError(
            f"unknown executor workload {workload!r}; "
            f"choose from {sorted(_EXECUTOR_KERNELS)}"
        ) from None
    check_mode(mode)
    return functools.partial(kernel, mode=mode)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    mode: Optional[str] = None,
) -> torch.Tensor:
    """Softmax attention. q: (b, h, sq, d); k/v: (b, hk, skv, d), hk | h.

    Matches :func:`repro_torch.kernels.ref.attention_ref` (which materializes
    the full score matrix; the kernels never do). On CUDA tensors the dtype
    picks the kernel: bf16 the tensor-core kernel (128 query rows x 128 keys,
    64 keys at head_dim 256), fp32 the FFMA kernel (64 query rows x 32 keys).
    The reference's Pallas tile sizes (``block_q``, ``block_k``) have no
    counterpart: the Hopper kernels' tiles are fixed.
    """
    if card_route(mode, q):
        return flash_attention_op(q, k, v, causal, window, scale)
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 scale=scale)


def tile_checksum(x: torch.Tensor, tile_dims: int = 2,
                  mode: Optional[str] = None) -> torch.Tensor:
    """zlib's CRC32 of every tile of ``x``: the last ``tile_dims`` dims form
    a tile, the leading dims index the tiles. Returns int64 values in
    [0, 2^32) shaped like the leading dims, on ``x``'s device. The kernel
    checksums every tile in one launch; both routes equal ``zlib.crc32``."""
    if use_kernel(mode, x):
        return tile_checksum_cuda(x, tile_dims)
    return tile_checksum_plain(x, tile_dims)


__all__ = [
    "MODES",
    "card_route",
    "check_mode",
    "executor_matmul",
    "flash_attention",
    "segmented_gather_ref",
    "tile_checksum",
    "usec_matmat",
    "usec_matvec",
    "usec_segmented",
    "use_kernel",
]
