"""Hopper kernels for softmax attention with an online softmax over KV tiles.

Replaces the TPU kernel
:func:`repro.kernels.flash_attention.flash_attention_padded` (body
``_flash_kernel``), the model stack's long-sequence attention. Two routes,
chosen by dtype alone: bf16 goes to the tensor-core kernel of
``csrc/flash_attention_tc.cu``, fp32 to the FFMA kernel of
``csrc/flash_attention.cu``. Plain version: :func:`flash_attention_plain`
below.

Semantics of ``_flash_kernel``: q (b, h, sq, d), k/v (b, hk, skv, d) with
hk | h (kv head = q head // (h / hk)); causal masking aligned to the end of
the KV sequence (query row r sits at KV position ``r + skv - sq``); an
optional sliding window keeps keys ``k > q - window``; the scores, running
max, denominator and accumulator are fp32, masked scores are the finite
-1e30 and the denominator is clamped at 1e-30, so a query with no live key
returns 0. The output is in q's dtype, rounded once.

Bound on the H100: operations (4·d FLOPs per live (query, key) pair). At
the model path's (1, 32, 8192, 128) causal bf16 layer that is 0.55 TFLOP,
0.556 ms at the bf16 tensor-core peak.

- bf16 (``launches_tc``): one CTA per (batch, head, 128-row query block),
  two consumer warpgroups of 64 rows and one producer thread; K/V tiles
  arrive by TMA into a 2-stage ring; Q·Kᵀ and P·V run on ``wgmma`` with
  fp32 accumulation. P is split into two bf16 parts (``p_hi = bf16(p)``,
  ``p_lo = bf16(p - p_hi)``) whose products go into the same accumulator,
  which keeps the bf16 output within one ulp of the fp32 reference (a
  single bf16 P does not: see ``tests/test_torch_kernels.py``).
- fp32 (``launches_ffma``): one CTA per (batch, head, 64-row query block)
  over 32-key tiles, every product and sum in fp32 FFMA, so it keeps the
  reference's fp32 rounding.

Both walk only their live KV tiles, mask ragged lengths in the kernel (the
wrapper pads nothing) and read Q, K, V through their strides, so a
(B, S, H, d) activation viewed as (B, H, S, d) is read in place.

The kernel is also the PyTorch operator ``torch.ops.repro_torch.
flash_attention`` (:func:`flash_attention_op`), which
``kernels.ops.flash_attention`` calls for card tensors: its implementation
is :func:`flash_attention_cuda` (one launch a call), its fake (meta)
implementation gives the output's shape and dtype without running anything
(the dry-run traces the model on meta tensors), and its flop formula, for
``torch.utils.flop_counter``, counts :func:`flash_flops`: 4·d per live
(query, key) pair a (batch, head), the count the bound above uses.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build
from .ref import attention_ref

__all__ = ["HEAD_DIMS", "flash_attention_cuda", "flash_attention_op",
           "flash_attention_plain", "flash_flops", "live_pairs"]

HEAD_DIMS = (32, 64, 80, 128, 256)  # one kernel instance each
_INT_MAX = 2 ** 31 - 1
# dtype -> (library, entry point, counter): the route is chosen by dtype.
_ROUTE = {torch.float32: ("flash_attention", "flash_attention_f32",
                          "launches_ffma"),
          torch.bfloat16: ("flash_attention_tc", "flash_attention_tc_bf16",
                           "launches_tc")}
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # elements per 16-byte load
_ENCODE_ERROR = 10000  # csrc/flash_attention_tc.cu's kEncodeError


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
    stem, name, _ = _ROUTE[dtype]
    lib = _build.library(stem)
    fn = getattr(lib, name)
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
    """Launch the kernel for q's dtype: bf16 on the tensor-core kernel
    (counted in ``launches_tc``), fp32 on the FFMA kernel
    (``launches_ffma``); ``launches`` counts both. q: (b, h, sq, d); k/v:
    (b, hk, skv, d), all CUDA, all fp32 or all bf16, unit stride on d, any
    (batch, head, row) strides that keep rows 16-byte aligned; d in
    :data:`HEAD_DIMS`. Returns a new contiguous (b, h, sq, d) tensor in q's
    dtype. Raises on anything the kernel does not take, and on a launch
    error.

    The kernel has no backward (the reference's ``flash_attention_padded``
    has none either): with grad enabled and an input that requires grad it
    raises, before anything else, rather than return an output cut off from
    the graph. Training reaches it through
    :class:`repro_torch.models.attention.FlashAttentionFn`, whose forward
    runs with grad disabled."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_cuda has no backward and would return an output "
            "detached from the graph; differentiate through "
            "repro_torch.models.attention.FlashAttentionFn, or call it under "
            "torch.no_grad()")
    if not q.is_cuda:
        raise ValueError("flash_attention_cuda needs CUDA tensors; use the "
                         "plain version (mode='ref') for host tensors")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"want q (b, h, sq, d) and k, v (b, hk, skv, d); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _ROUTE or k.dtype != q.dtype or v.dtype != q.dtype:
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
    if code >= _ENCODE_ERROR:
        raise RuntimeError(
            "flash_attention launch: cuTensorMapEncodeTiled refused a tensor "
            f"map (CUresult {code - _ENCODE_ERROR}; 0: no driver entry point)")
    _build.check(lib, code, "flash_attention launch")
    counter = _ROUTE[q.dtype][2]
    setattr(flash_attention_cuda, counter,
            getattr(flash_attention_cuda, counter) + 1)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_tc = 0
flash_attention_cuda.launches_ffma = 0


def live_pairs(sq: int, skv: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs the kernel's mask keeps, per (batch, head): query
    row r sits at key position ``r + skv - sq``."""
    q_pos = np.arange(sq, dtype=np.int64) + skv - sq
    hi = np.minimum(skv - 1, q_pos) if causal else np.full(sq, skv - 1)
    lo = np.maximum(0, q_pos - window + 1) if window else np.zeros(sq)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_flops(q_shape, k_shape, causal: bool = True,
                window: Optional[int] = None) -> int:
    """The attention's floating-point operations: 4·d per live (query, key)
    pair (2·d for Q·Kᵀ, 2·d for P·V) in each (batch, head)."""
    b, h, sq, d = q_shape
    return 4 * d * b * h * live_pairs(sq, k_shape[2], causal, window)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: Optional[int],
                       scale: Optional[float]) -> torch.Tensor:
    """:func:`flash_attention_cuda` as an operator: one kernel launch, or
    its error (any tensor that is not on a CUDA device raises there)."""
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                scale=scale)


@flash_attention_op.register_fake
def _(q, k, v, causal, window, scale):
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _(q_shape, k_shape, v_shape, causal, window, scale, *args,
      out_shape=None, **kwargs):
    return flash_flops(q_shape, k_shape, causal, window)
