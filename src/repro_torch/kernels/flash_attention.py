"""Hopper kernel for softmax attention with an online softmax over KV tiles.

Replaces the TPU kernel
:func:`repro.kernels.flash_attention.flash_attention_padded` (body
``_flash_kernel``), the model stack's long-sequence attention. Source:
``csrc/flash_attention.cu``; plain version: :func:`flash_attention_plain`
below.

Semantics of ``_flash_kernel``: q (b, h, sq, d), k/v (b, hk, skv, d) with
hk | h (kv head = q head // (h / hk)); causal masking aligned to the end of
the KV sequence (query row r sits at KV position ``r + skv - sq``); an
optional sliding window keeps keys ``k > q - window``; the scores, running
max, denominator and accumulator are fp32, masked scores are the finite
-1e30 and the denominator is clamped at 1e-30, so a query with no live key
returns 0. The output is in q's dtype.

Bound on the H100: operations (4·d FLOPs per live (query, key) pair). At
the model path's (1, 32, 8192, 128) causal bf16 layer that is 0.55 TFLOP;
the kernel computes in fp32 FFMA (67 TFLOP/s peak), keeping the reference's
fp32 rounding; tensor cores are a tuning step with a tolerance of its own.

Design: one CTA per (batch, head, 64-row query block) walks only its live
KV tiles of 32 keys in a loop, with m, l and the accumulator in registers
and the tiles in shared memory; ragged lengths are masked in the kernel, so
the wrapper pads nothing, and Q, K, V are read through their strides, so a
(B, S, H, d) activation viewed as (B, H, S, d) is read in place.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .ref import attention_ref

__all__ = ["HEAD_DIMS", "flash_attention_cuda", "flash_attention_plain"]

HEAD_DIMS = (32, 64, 80, 128, 256)  # one kernel instance each
_INT_MAX = 2 ** 31 - 1
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # elements per 16-byte load


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of the kernel, on whatever device its inputs lie on:
    :func:`.ref.attention_ref` over K and V expanded to q's head count.

    It materializes the (b, h, sq, skv) scores and masks with ``-inf``, so a
    query with no live key gives NaN where the kernel gives 0."""
    b, h = q.shape[:2]
    hk, skv, d = k.shape[1:]
    if h % hk:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hk}")
    g = h // hk
    if g > 1:
        k = k[:, :, None].expand(b, hk, g, skv, d).reshape(b, h, skv, d)
        v = v[:, :, None].expand(b, hk, g, skv, d).reshape(b, h, skv, d)
    return attention_ref(q, k, v, causal=causal, window=window, scale=scale)


def _entry(dtype: torch.dtype):
    lib = _build.library("flash_attention")
    fn = getattr(lib, _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 9
            + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


def _check_layout(name: str, t: torch.Tensor) -> None:
    vec = _VEC[t.dtype]
    if t.stride(3) != 1:
        raise ValueError(f"{name} needs unit stride on its last dim")
    if t.data_ptr() % 16 or any(t.stride(i) % vec for i in range(3)):
        raise ValueError(
            f"{name} must be 16-byte aligned with strides that are multiples "
            f"of {vec} elements; got strides {tuple(t.stride())}")


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch the kernel. q: (b, h, sq, d); k/v: (b, hk, skv, d), all CUDA,
    all fp32 or all bf16, unit stride on d, any (batch, head, row) strides
    that keep rows 16-byte aligned; d in :data:`HEAD_DIMS`. Returns a new
    contiguous (b, h, sq, d) tensor in q's dtype. Raises on anything the
    kernel does not take, and on a launch error."""
    if not q.is_cuda:
        raise ValueError("flash_attention_cuda needs CUDA tensors; use the "
                         "plain version (mode='ref') for host tensors")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"want q (b, h, sq, d) and k, v (b, hk, skv, d); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or all bfloat16; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    b, h, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if hk == 0 or h % hk:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hk}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} has no kernel instance; "
                         f"supported: {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t)
    if max(b * h, sq, skv, window or 0) > _INT_MAX or sq > 65535 * 64:
        raise ValueError("shape exceeds the kernel's int32 / grid limits")
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    lib, fn = _entry(q.dtype)
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        b, h, hk, sq, skv, d, int(bool(causal)), int(window or 0),
        float(scale), _build.stream_handle(q.device),
    )
    _build.check(lib, code, "flash_attention launch")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
