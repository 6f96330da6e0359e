"""Mamba-2 block (SSD — state-space duality, arXiv:2405.21060).

Twin of :mod:`repro.models.ssm` (serving and training). Prefill runs the
chunked SSD algorithm (chunk length ``cfg.ssm_chunk``): the intra-chunk
quadratic term, each chunk's state and its decays for all chunks at once
in batched einsums, then a loop over chunks for the (B, H, P, N) state
recurrence only, and the carried states' contribution in one more einsum.
The reference scans over chunks with every term inside the step; the
values are the same up to the fp32 sum order (tolerance-equal, not
bitwise). Decode is the selective-SSM recurrence with a persistent
(H, P, N) state, O(1) per token; it writes the new conv and SSM states
into the cache it is given, in place.

Layout: d_inner = expand * d_model; H = d_inner / head_dim heads; state N per
head; single B/C group (ngroups=1). ``A_log``, ``D`` and ``dt_bias`` are
fp32 leaves in a model of any ``param_dtype``, as in the reference.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from .layers import causal_depthwise_conv, dense_init, dtype_of, normal_
from .parallel import copy_to_model, gather_from_model, over, slice_to_model

F32 = torch.float32


def _dims(cfg):
    """(d_inner, state N, heads H)."""
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, cfg.ssm_state, d_in // cfg.ssm_head_dim


def init_ssm(generator, cfg, device=None, lead=()) -> Dict:
    dt = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    d_in, n, h = _dims(cfg)
    lead = tuple(lead)
    d_proj = 2 * d_in + 2 * n + h  # z, x, B, C, dt
    conv_w = torch.empty(lead + (cfg.ssm_conv, d_in + 2 * n), dtype=dt,
                         device=device)
    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=F32, device=device))
    return {
        "w_in": dense_init(generator, d, d_proj, dt, device=device, lead=lead),
        "conv_w": normal_(conv_w, generator, 0.1),
        "A_log": a_log.expand(lead + (h,)).clone(),
        "D": torch.ones(lead + (h,), dtype=F32, device=device),
        "dt_bias": torch.zeros(lead + (h,), dtype=F32, device=device),
        "norm_scale": torch.ones(lead + (d_in,), dtype=dt, device=device),
        "w_out": dense_init(generator, d_in, d, dt, device=device, lead=lead),
    }


def _split_proj(proj, cfg):
    d_in, n, _ = _dims(cfg)
    z = proj[..., :d_in]
    xbc = proj[..., d_in: 2 * d_in + 2 * n]
    dt = proj[..., 2 * d_in + 2 * n:]
    return z, xbc, dt


def _gated_norm(x, z, scale, eps=1e-6):
    x = x * F.silu(z.to(F32)).to(x.dtype)
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(F32)).to(x.dtype)


def _segsum(a):
    """segsum(a)[..., i, j] = sum_{j < k <= i} a[..., k] (-inf for j > i):
    differences of one cumsum, as the reference computes it."""
    l = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, -math.inf)


def ssd_chunked(x, a, b, c, chunk):
    """SSD scan. x: (B,S,H,P); a: (B,S,H) (= dt*A, negative); b/c: (B,S,N).

    Returns y: (B,S,H,P) in ``x.dtype``; S is zero-padded to whole chunks.
    Every chunk's intra-chunk term, state and decays come from one batched
    einsum each (fp32); only the state recurrence loops over the chunks.
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    xs = x.reshape(bsz, nc, chunk, h, p).to(F32)
    as_ = a.reshape(bsz, nc, chunk, h).to(F32)
    bs = b.reshape(bsz, nc, chunk, n).to(F32)
    cs = c.reshape(bsz, nc, chunk, n).to(F32)

    # Cumsums run along the last, contiguous axis: a scan down an outer
    # axis is a slow kernel on the card.
    a_t = as_.transpose(2, 3).contiguous()                     # (B,c,H,l)
    a_cum = torch.cumsum(a_t, dim=-1).transpose(2, 3)          # (B,c,l,H)
    # Intra-chunk (the "attention-like" quadratic term).
    ls = torch.exp(_segsum(a_t))                               # (B,c,H,l,l)
    scores = torch.einsum("bcln,bcmn->bclm", cs, bs)           # (B,c,l,m)
    y_diag = torch.einsum("bchlm,bclm,bcmhp->bclhp", ls, scores, xs)
    del ls
    # Each chunk's own state and its decay over the whole chunk.
    decay_states = torch.exp(a_cum[:, :, -1:, :] - a_cum)      # (B,c,l,H)
    new_states = torch.einsum("bcln,bclh,bclhp->bchpn", bs, decay_states, xs)
    chunk_decay = torch.exp(a_cum[:, :, -1, :])                # (B,c,H)
    # The carried state entering each chunk: the only sequential part.
    state = torch.zeros((bsz, h, p, n), dtype=F32, device=x.device)
    carried = []
    for i in range(nc):
        carried.append(state)
        state = state * chunk_decay[:, i, :, None, None] + new_states[:, i]
    carried = torch.stack(carried, dim=1)                      # (B,c,H,P,N)
    y_off = torch.einsum("bcln,bchpn,bclh->bclhp", cs, carried,
                         torch.exp(a_cum))
    y = (y_diag + y_off).reshape(bsz, nc * chunk, h, p)
    return y[:, :s].to(x.dtype)


def _in_proj(params: Dict, u: torch.Tensor, cfg, conv_state=None, proj=None):
    """The block's input side: (z, xbc before the conv, x, B, C, dt, the
    conv's new state). x, B, C are the conv's SiLU output in ``u``'s dtype;
    dt = softplus(dt_raw + dt_bias) in fp32. ``proj``: ``u @ w_in`` when
    the caller has it."""
    d_in, n, _ = _dims(cfg)
    if proj is None:
        proj = u @ params["w_in"]
    z, xbc, dt_raw = _split_proj(proj, cfg)
    xbc_c, conv_state = causal_depthwise_conv(xbc, params["conv_w"],
                                              conv_state)
    xbc_c = F.silu(xbc_c.to(F32)).to(xbc_c.dtype)
    x = xbc_c[..., :d_in]
    b = xbc_c[..., d_in: d_in + n]
    c = xbc_c[..., d_in + n:]
    dt = F.softplus(dt_raw.to(F32) + params["dt_bias"])
    return z, xbc, x, b, c, dt, conv_state


def _out(params: Dict, y, xh, z, tp=None):
    """D skip, gated norm and out-projection of the heads' output ``y``
    (B, S, H, P) with the heads' input ``xh``; with ``tp`` (``w_out``'s rows
    split) this rank's columns of the normed output times its rows: a
    partial sum."""
    bsz, s = y.shape[:2]
    y = y + params["D"][None, None, :, None] * xh.to(F32)
    y = _gated_norm(y.reshape(bsz, s, -1), z, params["norm_scale"])
    # y is fp32 (the fp32 D made it so): JAX promotes y @ w_out to fp32.
    return slice_to_model(y, tp) @ params["w_out"].to(F32)


def ssm_forward(params: Dict, z, x, b, c, dt, cfg, tp=None) -> torch.Tensor:
    """The chunked SSD over the whole sequence from :func:`_in_proj`'s
    pieces: (B, S, D) (a partial sum with ``tp``, see :func:`_out`)."""
    a = -torch.exp(params["A_log"])                            # (H,)
    bsz, s, _ = x.shape
    xh = x.reshape(bsz, s, -1, cfg.ssm_head_dim)
    y = ssd_chunked(xh * dt[..., None].to(xh.dtype), dt * a, b, c,
                    cfg.ssm_chunk)
    return _out(params, y, xh, z, tp)


def apply_ssm_train(params: Dict, u: torch.Tensor, cfg) -> torch.Tensor:
    """u: (B, S, D) -> (B, S, D), forward only (the prefill's output)."""
    return ssm_parts(params, u, cfg)[1]


def ssm_parts(params: Dict, u: torch.Tensor, cfg, tp=None):
    """(partial, whole) of :func:`apply_ssm_train`. Over a model group the
    block takes the plain route: the split ``w_in`` output, ``conv_w`` and
    ``norm_scale`` are gathered whole, the conv and the SSD scan run whole
    on every rank, and a split ``w_out`` reads this rank's columns of the
    normed output (a partial sum)."""
    d_in, n, h = _dims(cfg)
    in_tp = over(tp, params["w_in"].shape[-1], 2 * d_in + 2 * n + h)
    out_tp = over(tp, params["w_out"].shape[-2], d_in)
    params = dict(params)
    for name, width in (("conv_w", d_in + 2 * n), ("norm_scale", d_in)):
        params[name] = gather_from_model(
            params[name], over(tp, params[name].shape[-1], width))
    proj = None
    if in_tp is not None:
        proj = gather_from_model(copy_to_model(u, tp) @ params["w_in"], tp)
    z, _, x, b, c, dt, _ = _in_proj(params, u, cfg, proj=proj)
    y = ssm_forward(params, z, x, b, c, dt, cfg, out_tp)
    return (y, None) if out_tp is not None else (None, y)


# ---------------------------------------------------------------------- #
# Decode
# ---------------------------------------------------------------------- #
def init_ssm_cache(cfg, batch: int, device=None, lead=()) -> Dict:
    dt = dtype_of(cfg.param_dtype)
    d_in, n, h = _dims(cfg)
    lead = tuple(lead)
    return {
        "conv": torch.zeros(lead + (batch, cfg.ssm_conv - 1, d_in + 2 * n),
                            dtype=dt, device=device),
        "state": torch.zeros(lead + (batch, h, cfg.ssm_head_dim, n),
                             dtype=F32, device=device),
    }


def apply_ssm_decode(params: Dict, u: torch.Tensor, cache: Dict, cfg):
    """u: (B, 1, D). Returns (y, cache): the new conv and SSM states are
    written into ``cache``'s tensors in place. O(1) per token."""
    z, _, x, b, c, dt, conv_state = _in_proj(params, u, cfg, cache["conv"])
    dt = dt[:, 0]                                              # (B,H)
    a = -torch.exp(params["A_log"])
    da = torch.exp(dt * a)                                     # (B,H)
    xh = x[:, 0].reshape(x.shape[0], -1, cfg.ssm_head_dim).to(F32)  # (B,H,P)
    bx = torch.einsum("bn,bhp->bhpn", b[:, 0].to(F32), xh * dt[..., None])
    state = cache["state"] * da[..., None, None] + bx
    y = torch.einsum("bhpn,bn->bhp", state, c[:, 0].to(F32))
    cache["conv"].copy_(conv_state)
    cache["state"].copy_(state)
    return _out(params, y[:, None], xh[:, None], z), cache
