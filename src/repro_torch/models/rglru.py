"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Twin of :mod:`repro.models.rglru` for the serving path. The recurrence

  h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)  with
  r_t = sigmoid(W_a x_t + b_a)        (recurrence gate)
  i_t = sigmoid(W_x x_t + b_x)        (input gate)
  a_t = exp(-c · softplus(Λ) · r_t)   (per-channel decay, c = 8)

is linear in h. The reference runs ``jax.lax.associative_scan`` over the
(a, b) pairs; here :func:`linear_scan` is a Hillis–Steele scan over the
sequence axis with :func:`_assoc` (ceil(log2 S) levels of tensor ops), in
fp32 as the reference's ``log_a``, ``b`` and ``h``. The two trees combine
the pairs in another order, so ``h`` is tolerance-equal to the
reference's, not bitwise. It multiplies decays and never divides by their
products, which underflow fp32 within a few dozen tokens as r -> 1.
Decode carries a single (B, D_rnn) state and writes it, with the conv
state, into the cache it is given, in place. ``b_a``, ``b_i`` and ``lam``
are fp32 leaves in a model of any ``param_dtype``, as in the reference.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .layers import _gelu, causal_depthwise_conv, dense_init, dtype_of, normal_

F32 = torch.float32
_C = 8.0


def init_rglru(generator, cfg, device=None, lead=()) -> Dict:
    dt = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    dr = cfg.rglru_expand * d
    lead = tuple(lead)

    def dense(d_in, d_out):
        return dense_init(generator, d_in, d_out, dt, device=device, lead=lead)

    conv_w = torch.empty(lead + (4, dr), dtype=dt, device=device)
    return {
        "w_x": dense(d, dr),        # recurrent branch in
        "w_gate": dense(d, dr),     # GeLU gate branch
        "conv_w": normal_(conv_w, generator, 0.1),
        "w_a": dense(dr, dr),
        "b_a": torch.zeros(lead + (dr,), dtype=F32, device=device),
        "w_i": dense(dr, dr),
        "b_i": torch.zeros(lead + (dr,), dtype=F32, device=device),
        "lam": torch.full(lead + (dr,), 0.55, dtype=F32, device=device),
        "w_out": dense(dr, d),
    }


def _gates(p, x):
    """x: (B, S, Dr) -> log_a (f32), gated input b (f32)."""
    xf = x.to(F32)
    r = torch.sigmoid(xf @ p["w_a"].to(F32) + p["b_a"])
    i = torch.sigmoid(xf @ p["w_i"].to(F32) + p["b_i"])
    log_a = -_C * F.softplus(p["lam"]) * r                  # (B,S,Dr), <= 0
    a2 = torch.exp(2.0 * log_a)
    b = torch.sqrt(torch.clamp(1.0 - a2, min=1e-9)) * (i * xf)
    return log_a, b


def _assoc(left, right):
    (a1, b1), (a2, b2) = left, right
    return a1 * a2, a2 * b1 + b2


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over axis 1 from h_{-1} = 0: the inclusive
    scan of (a, b) under :func:`_assoc`, Hillis–Steele (each level combines
    every element with the one ``shift`` before it). Returns h, b's shape."""
    s = a.shape[1]
    shift = 1
    while shift < s:
        a_new, b_new = _assoc((a[:, :-shift], b[:, :-shift]),
                              (a[:, shift:], b[:, shift:]))
        b = torch.cat([b[:, :shift], b_new], dim=1)
        if 2 * shift < s:  # the last level needs no decays
            a = torch.cat([a[:, :shift], a_new], dim=1)
        shift *= 2
    return b


def _out(p, h, gate, dtype):
    return (h * gate).to(dtype) @ p["w_out"]


def rglru_prefill(p: Dict, u: torch.Tensor, cfg):
    """u: (B, S, D) -> (y, cache): the block over the prompt and its decode
    cache (the conv's last K-1 inputs, the final state). The reference
    computes the cache by running the projection, conv and scan a second
    time (``_rglru_state_from_prefill``); the values are identical, so
    here they run once."""
    x = u @ p["w_x"]
    gate = _gelu((u @ p["w_gate"]).to(F32))
    xc, _ = causal_depthwise_conv(x, p["conv_w"])
    log_a, b = _gates(p, xc)
    h = linear_scan(torch.exp(log_a), b)
    tail = x[:, -(p["conv_w"].shape[-2] - 1):, :]
    return _out(p, h, gate, u.dtype), {"conv": tail, "h": h[:, -1]}


def apply_rglru_train(p: Dict, u: torch.Tensor, cfg) -> torch.Tensor:
    """u: (B, S, D) -> (B, S, D), forward only (the prefill's output)."""
    return rglru_prefill(p, u, cfg)[0]


def init_rglru_cache(cfg, batch: int, device=None, lead=()) -> Dict:
    dt = dtype_of(cfg.param_dtype)
    dr = cfg.rglru_expand * cfg.d_model
    lead = tuple(lead)
    return {
        "conv": torch.zeros(lead + (batch, 3, dr), dtype=dt, device=device),
        "h": torch.zeros(lead + (batch, dr), dtype=F32, device=device),
    }


def apply_rglru_decode(p: Dict, u: torch.Tensor, cache: Dict, cfg):
    """u: (B, 1, D) -> (y, cache): the new conv state and h are written
    into ``cache``'s tensors in place."""
    x = u @ p["w_x"]
    gate = _gelu((u @ p["w_gate"]).to(F32))
    x, conv_state = causal_depthwise_conv(x, p["conv_w"], cache["conv"])
    log_a, b = _gates(p, x)
    h = torch.exp(log_a)[:, 0] * cache["h"] + b[:, 0]         # (B, Dr)
    cache["conv"].copy_(conv_state)
    cache["h"].copy_(h)
    return _out(p, h[:, None, :], gate, u.dtype), cache
