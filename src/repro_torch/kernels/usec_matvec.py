"""Hopper kernel for the USEC block-row matvec ``Y = X @ W`` (fp32 accumulate).

Replaces the TPU kernel :func:`repro.kernels.usec_matvec.usec_matvec_padded`
(body ``_matvec_kernel``), the per-block matmul of the default executor path.
Source: ``csrc/usec_matvec.cu``; plain version: :func:`.ref.matvec_ref`.

Bound on the H100: memory. At the main path's C = 1 every 4-byte X element
feeds 2 flops, so the least time is ``(M*K*sizeof(X) + K*C*4 + M*C*4)`` bytes
over 3.35 TB/s. A main-path block (20 x 6000 fp32) is about 0.15 us of bytes,
less than a launch costs, so the per-block executor path pays a launch per
block whatever the kernel does; the segmented kernel (:mod:`.usec_segmented`)
is the design's answer to that.

Design: K split across a thread block cluster of :data:`CLUSTER` CTAs per
(output row, tile of up to 8 columns). Each CTA's 4 warps reduce one eighth
of K with 16-byte loads and a scalar tail (one or two loads a thread at
K = 6000, all in flight at once) and sum their partials in a fixed order;
rank 0 then sums the 8 CTA partials in rank order through distributed
shared memory. No atomics, no global scratch, so two runs give the same
bits. A 20-row block runs on 160 CTAs instead of 20. X is taken with its
row stride, so a block of the staged buffer is a view and is never copied;
ragged M, K and C are handled in the kernel, so the wrapper pads nothing
(the TPU wrapper padded every call).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .ref import matvec_ref

__all__ = ["CLUSTER", "matvec_ref", "usec_matvec_cuda"]

CLUSTER = 8  # CTAs per output row (csrc/usec_matvec.cu's kCluster)
_INT_MAX = 2 ** 31 - 1
_ENTRY = {torch.float32: "usec_matvec_f32", torch.bfloat16: "usec_matvec_bf16"}


def _entry(dtype: torch.dtype):
    lib = _build.library("usec_matvec")
    fn = getattr(lib, _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib, fn


def usec_matvec_cuda(
    x: torch.Tensor, w: torch.Tensor, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Launch the kernel: ``out = X @ W``. x: (M, K) fp32 or bf16 with unit
    column stride (any row stride); w: (K, C), cast to fp32; out: (M, C)
    fp32 with unit column stride, allocated when None. Raises on anything
    the kernel does not take, and on a launch error."""
    if not x.is_cuda:
        raise ValueError("usec_matvec_cuda needs CUDA tensors; use the "
                         "plain version (mode='ref') for host tensors")
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"want x (M, K) and w (K, C); got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    if x.dtype not in _ENTRY:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    m, k = x.shape
    k2, c = w.shape
    if k != k2:
        raise ValueError(f"inner dims disagree: {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    w = w.to(torch.float32)
    if w.device != x.device:
        raise ValueError(f"w on {w.device}, x on {x.device}")
    if out is None:
        out = torch.empty((m, c), dtype=torch.float32, device=x.device)
    elif (out.shape != (m, c) or out.dtype != torch.float32
          or out.device != x.device):
        raise ValueError(f"out must be ({m}, {c}) float32 on {x.device}")
    if m == 0 or c == 0:
        return out
    if not all(t.shape[1] <= 1 or t.stride(1) == 1 for t in (x, w, out)):
        raise ValueError("x, w and out need unit column stride")
    if max(m * CLUSTER, k, c, x.stride(0), w.stride(0),
           out.stride(0)) > _INT_MAX:
        raise ValueError("shape or stride exceeds int32")
    if (c + 7) // 8 > 65535:
        raise ValueError(f"C={c} exceeds the kernel's column-tile grid")
    lib, fn = _entry(x.dtype)
    code = fn(
        x.data_ptr(), x.stride(0), w.data_ptr(), w.stride(0),
        out.data_ptr(), out.stride(0), m, k, c,
        _build.stream_handle(x.device),
    )
    _build.check(lib, code, "usec_matvec launch")
    usec_matvec_cuda.launches += 1
    return out


usec_matvec_cuda.launches = 0
