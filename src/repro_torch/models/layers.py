"""Primitive layers: norms, rotary embeddings, MLPs, the causal depthwise
conv, initializers.

Twin of :mod:`repro.models.layers`. Pure-function style: ``init_*`` builds a
param dict of tensors; the matching ``apply`` is a plain function. Params
live in ``cfg.param_dtype`` (bf16 by default); norms and rotary angles
compute in fp32 and cast back. Initializers draw from an explicit
``torch.Generator`` and write each leaf in its final dtype on its final
device, a bounded fp32 chunk at a time.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .parallel import at, copy_to_model, row_runs

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}
_INIT_CHUNK = 1 << 24  # fp32 elements drawn at once (64 MB)


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def normal_(out: torch.Tensor, generator: torch.Generator, scale: float,
            cut=None) -> torch.Tensor:
    """Fill ``out`` in place with ``N(0, 1) * scale`` drawn in fp32, then
    rounded once to ``out``'s dtype. Rows are drawn in chunks, so a large
    low-precision leaf never has a full fp32 copy.

    ``cut`` (a :class:`repro_torch.models.parallel.InitCut` at this leaf):
    ``out`` is this rank's slice of the whole leaf; the whole leaf's chunks
    are drawn in the same order and shapes and each keeps only the slice's
    elements, so the slice is bitwise the whole draw's and no whole leaf
    (nor more than one chunk) is ever allocated."""
    box = None if cut is None else cut.box()
    if box is None or box.whole:
        flat = out.view(-1, out.shape[-1]) if out.ndim > 1 else out.view(1, -1)
        rows = max(1, _INIT_CHUNK // max(flat.shape[1], 1))
        for part in flat.split(rows):
            draw = torch.randn(part.shape, generator=generator,
                               dtype=torch.float32, device=out.device)
            part.copy_(draw.mul_(scale))
            del draw
        return out
    n_rows, n_cols = math.prod(box.shape[:-1]), box.shape[-1]
    c0, cn = box.lo[-1], box.size[-1]
    flat = out.view(-1, cn)
    rows = max(1, _INIT_CHUNK // max(n_cols, 1))
    runs, first = row_runs(box), 0
    for r0 in range(0, n_rows, rows):
        r1 = min(r0 + rows, n_rows)
        draw = torch.randn((r1 - r0, n_cols), generator=generator,
                           dtype=torch.float32, device=out.device)
        while first < len(runs) and sum(runs[first][:2]) <= r0:
            first += 1
        for g, n, local in itertools.takewhile(lambda run: run[0] < r1,
                                               runs[first:]):
            a, b = max(g, r0), min(g + n, r1)
            flat[local + a - g: local + b - g].copy_(
                draw[a - r0: b - r0, c0: c0 + cn].mul_(scale))
        del draw
    return out


def empty(shape, dtype, device=None, cut=None) -> torch.Tensor:
    """An uninitialized leaf of ``shape``, or this rank's slice of it."""
    shape = tuple(shape) if cut is None else cut.local(shape)
    return torch.empty(shape, dtype=dtype, device=device)


def full(shape, value: float, dtype, device=None, cut=None) -> torch.Tensor:
    """A leaf of ``shape`` filled with ``value``, or this rank's slice."""
    shape = tuple(shape) if cut is None else cut.local(shape)
    return torch.full(shape, value, dtype=dtype, device=device)


def dense_init(generator: torch.Generator, d_in: int, d_out: int, dtype,
               scale: Optional[float] = None, device=None, lead=(),
               cut=None) -> torch.Tensor:
    """A (``*lead``, d_in, d_out) weight, ``N(0, 1) * scale`` (default
    ``d_in ** -0.5``). ``lead`` stacks independent draws (the layer axis);
    ``cut``: this rank's slice of it (:func:`normal_`)."""
    s = scale if scale is not None else d_in ** -0.5
    out = empty(tuple(lead) + (d_in, d_out), dtype, device, cut)
    return normal_(out, generator, s, cut)


# ---------------------------------------------------------------------- #
# Norms
# ---------------------------------------------------------------------- #
def init_norm(d: int, kind: str, dtype, device=None, lead=(),
              cut=None) -> Dict:
    shape = tuple(lead) + (d,)
    p = {"scale": full(shape, 1.0, dtype, device, at(cut, "scale"))}
    if kind == "layernorm":
        p["bias"] = full(shape, 0.0, dtype, device, at(cut, "bias"))
    return p


def apply_norm(p: Dict, x: torch.Tensor, kind: str, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
    elif kind == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
    else:
        raise ValueError(kind)
    y = y * p["scale"].to(torch.float32)
    if "bias" in p:
        y = y + p["bias"].to(torch.float32)
    return y.to(x.dtype)


# ---------------------------------------------------------------------- #
# Rotary position embedding
# ---------------------------------------------------------------------- #
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, n_heads, head_dim); positions: (..., seq) integer."""
    head_dim = x.shape[-1]
    half = head_dim // 2
    # A Python scalar base: no host-to-device copy (which would block the
    # host on every call), and the power is taken in fp32 as in the reference.
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]  # (..., seq, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------- #
# MLPs
# ---------------------------------------------------------------------- #
GATED_ACTS = ("swiglu", "geglu")


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation.
    return F.gelu(x, approximate="tanh")


def init_mlp(generator: torch.Generator, d: int, f: int, act: str, dtype,
             device=None, lead=(), cut=None) -> Dict:
    if act in GATED_ACTS:
        names = ("w_gate", "w_up", "w_down")
    else:
        names = ("w_up", "w_down")
    return {n: dense_init(generator, *((f, d) if n == "w_down" else (d, f)),
                          dtype, device=device, lead=lead, cut=at(cut, n))
            for n in names}


def apply_mlp(p: Dict, x: torch.Tensor, act: str) -> torch.Tensor:
    return mlp_parts(p, x, act)[1]


def mlp_parts(p: Dict, x: torch.Tensor, act: str, tp=None):
    """(partial, whole) of :func:`apply_mlp`. Split (``tp``): ``w_gate`` and
    ``w_up`` by column, ``w_down`` by row; the activation runs on the local
    columns, and each rank's product is a partial sum (reduced by
    :func:`repro_torch.models.parallel.finish`)."""
    x = copy_to_model(x, tp)
    if act in GATED_ACTS:
        gate_fn = F.silu if act == "swiglu" else _gelu
        g = gate_fn(x @ p["w_gate"])
        out = (g * (x @ p["w_up"])) @ p["w_down"]
    else:
        h = x @ p["w_up"]
        if act == "gelu":
            h = _gelu(h)
        elif act == "squared_relu":
            h = torch.square(F.relu(h))
        else:
            raise ValueError(act)
        out = h @ p["w_down"]
    return (out, None) if tp is not None else (None, out)


def causal_depthwise_conv(
    x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal 1D conv. x: (B, S, C); w: (K, C).

    Returns (y, new_state) where state is the trailing (K-1) inputs for
    streaming decode. When ``state`` is given it is prepended (decode path);
    otherwise zero history (training path). ``y`` and the state are in
    ``x.dtype``; the K shifted products are summed in the reference's
    order, in ``x.dtype``.
    """
    b, s, c = x.shape
    k = w.shape[0]
    if state is None:
        state = torch.zeros((b, k - 1, c), dtype=x.dtype, device=x.device)
    xx = torch.cat([state, x], dim=1)  # (B, S+K-1, C)
    y = sum(xx[:, i: i + s, :] * w[i][None, None, :] for i in range(k))
    new_state = xx[:, xx.shape[1] - (k - 1):, :]
    return y.to(x.dtype), new_state
