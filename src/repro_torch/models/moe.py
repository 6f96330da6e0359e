"""Mixture-of-experts FFN: GShard-style capacity routing.

Twin of :mod:`repro.models.moe` (serving and training). Covers both MoE archs:

  * llama4-scout-17b-a16e : 16 experts, top-1, 1 shared expert
  * deepseek-moe-16b      : 64 fine-grained experts, top-6, 2 shared experts

The routing is the reference's, bit for bit: an fp32 router, top-k with the
lower expert index first on ties (``jax.lax.top_k``'s order), the capacity
``max(int(t·k/E·capacity_factor), 1)`` per chunk, and each (token, choice)
placed in its expert's buffer in token-major, choice-minor order; a choice
past the capacity is dropped. The reference moves tokens with dense one-hot
``(T, E, C)`` einsums; here dispatch and combine are index operations on
the same slots (each ``(expert, slot)`` holds at most one token, so the
gather is exact), and the experts run as batched products over
``(E, C, ·)``. :func:`moe_chunk_plain` keeps the literal one-hot form as the
plain version the tests and ``chip_smoke.py`` hold the main path to. The
reference's GSPMD sharding hints have no counterpart on one card.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .layers import _gelu, dense_init, dtype_of, init_mlp, mlp_parts
from .parallel import at, copy_to_model, over


def init_moe(generator: torch.Generator, cfg, device=None, lead=(),
             cut=None) -> Dict:
    """The reference's ``init_moe`` tree: an fp32 ``router`` (d, E) and the
    experts stacked on a leading E axis, ``N(0, 1) · d_in ** -0.5`` in
    ``cfg.param_dtype``; ``lead`` stacks layers; ``cut``: this rank's
    slices (:func:`repro_torch.models.layers.normal_`)."""
    dt = dtype_of(cfg.param_dtype)
    d, fe, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    lead = tuple(lead)
    p = {
        "router": dense_init(generator, d, e, torch.float32, device=device,
                             lead=lead, cut=at(cut, "router")),
        "w_up": dense_init(generator, d, fe, dt, device=device,
                           lead=lead + (e,), cut=at(cut, "w_up")),
        "w_down": dense_init(generator, fe, d, dt, device=device,
                             lead=lead + (e,), cut=at(cut, "w_down")),
    }
    if cfg.act == "swiglu":
        p["w_gate"] = dense_init(generator, d, fe, dt, device=device,
                                 lead=lead + (e,), cut=at(cut, "w_gate"))
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(generator, d, fe * cfg.n_shared_experts,
                               cfg.act, dt, device, lead,
                               at(cut, "shared"))
    return p


def apply_moe(p: Dict, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D). Returns (out, aux_loss).

    A stream longer than ``cfg.moe_chunk`` tokens is padded with zero rows
    to whole chunks and routed chunk by chunk (each chunk has its own
    capacity; the padded rows take slots after every real token of the last
    chunk); ``aux`` is the mean over chunks. (Over model shards:
    :func:`moe_parts`.)"""
    parts, aux = moe_parts(p, x, cfg)
    return parts[1], aux


def moe_parts(p: Dict, x: torch.Tensor, cfg, tp=None):
    """((partial, whole), aux) of :func:`apply_moe`. With ``tp`` the experts
    are split over the model group (E/M a rank, expert parallelism): the
    router and the routing run whole on every rank (the same capacity and
    drops), each rank runs its own experts on the tokens routed to them,
    and its combine is a partial sum; the shared experts are split by
    column and row, as the MLP. The tokens and the combine weights enter
    the sharded region through ``copy_to_model``, so the router's gradient
    sums every rank's experts."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    etp = over(tp, p["w_up"].shape[0], cfg.n_experts)
    chunk = min(cfg.moe_chunk, t)
    if t > chunk:
        nchunks = -(-t // chunk)
        xp = F.pad(xt, (0, 0, 0, nchunks * chunk - t))
        outs, auxs = zip(*(moe_chunk(p, xc, cfg, etp)
                           for xc in xp.split(chunk)))
        out = torch.cat(outs)[:t].reshape(b, s, d)
        aux = torch.stack(auxs).mean()
    else:
        out_t, aux = moe_chunk(p, xt, cfg, etp)
        out = out_t.reshape(b, s, d)
    parts = [None, None]
    parts[etp is None] = out
    if cfg.n_shared_experts:
        shared = p["shared"]
        stp = over(tp, shared["w_up"].shape[-1],
                   cfg.moe_d_ff * cfg.n_shared_experts)
        sp, sw = mlp_parts(shared, x, cfg.act, stp)
        for i, y in ((0, sp), (1, sw)):
            if y is not None:
                y = y.reshape(b, s, d)
                parts[i] = y if parts[i] is None else parts[i] + y
    return tuple(parts), aux


class Routing(NamedTuple):
    """One chunk's routing. ``idx``, ``pos``, ``keep`` and ``gates`` are
    (T, k), in the reference's token-major, choice-minor order."""
    probs: torch.Tensor  # (T, E) fp32 router softmax
    idx: torch.Tensor    # expert of each choice, int64
    pos: torch.Tensor    # its slot in that expert's buffer, int64
    keep: torch.Tensor   # pos < capacity
    gates: torch.Tensor  # fp32 weights, renormalized over k, 0 where dropped
    counts: torch.Tensor  # (E,) choices sent to each expert, dropped or not
    capacity: int


def route(router: torch.Tensor, xt: torch.Tensor, cfg) -> Routing:
    """Route the chunk ``xt`` (T, D) as the reference's ``_moe_chunk``."""
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(xt.to(torch.float32) @ router, dim=-1)
    # jax.lax.top_k's order: descending, the lower index first on ties
    # (torch.topk leaves ties in no set order).
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    capacity = max(int(t * k / e * cfg.capacity_factor), 1)
    # Slot of each (token, choice): how many earlier choices in token-major
    # order went to the same expert (an exclusive count, in integers). A
    # stable sort by expert keeps that order within each expert's run, so
    # the slot is the rank in the run. (A cumsum down the (T·k, E) one-hot
    # computes the same, but as a scan over its outer dimension it was the
    # largest kernel of the H100 prefill.)
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(e, dtype=flat.dtype, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    starts = torch.cumsum(counts, dim=0) - counts
    rank = torch.arange(flat.numel(), device=flat.device) - starts[flat[order]]
    pos = torch.empty_like(flat).scatter_(0, order, rank).reshape(t, k)
    keep = pos < capacity
    return Routing(probs, idx, pos, keep, vals * keep, counts, capacity)


def _slots(r: Routing) -> torch.Tensor:
    """Each choice's row in the flat (E·C, D) buffer; a dropped choice
    points at the spare row E·C."""
    n = r.probs.shape[1] * r.capacity
    return torch.where(r.keep, r.idx * r.capacity + r.pos, n)


def dispatch(xt: torch.Tensor, r: Routing) -> torch.Tensor:
    """The experts' input buffer (E, C, D): each kept (token, choice) row
    copied into its (expert, slot), the other slots zero."""
    e, c, d = r.probs.shape[1], r.capacity, xt.shape[1]
    buf = xt.new_zeros((e * c + 1, d))
    slots = _slots(r)
    for i in range(slots.shape[1]):
        buf[slots[:, i]] = xt
    return buf[:-1].view(e, c, d)


def experts(p: Dict, xin: torch.Tensor, act: str) -> torch.Tensor:
    """(E, C, D) -> (E, C, D): every expert's FFN on its buffer."""
    if act == "swiglu":
        h = F.silu(torch.bmm(xin, p["w_gate"])) * torch.bmm(xin, p["w_up"])
    else:
        h = torch.bmm(xin, p["w_up"])
        h = _gelu(h) if act == "gelu" else torch.square(F.relu(h))
    return torch.bmm(h, p["w_down"])


def combine(eout: torch.Tensor, r: Routing) -> torch.Tensor:
    """(T, D): each token's kept slots summed in fp32 with its gate weights
    rounded to the experts' dtype first (the reference's
    ``combine.astype(eout.dtype)``)."""
    flat = eout.reshape(-1, eout.shape[-1])
    slots = torch.clamp(_slots(r), max=flat.shape[0] - 1)  # dropped: gate 0
    w = r.gates.to(eout.dtype).to(torch.float32)
    out = torch.zeros((slots.shape[0], flat.shape[1]), dtype=torch.float32,
                      device=eout.device)
    for i in range(slots.shape[1]):
        out += w[:, i:i + 1] * flat.index_select(0, slots[:, i]).to(
            torch.float32)
    return out.to(eout.dtype)


def aux_loss(r: Routing) -> torch.Tensor:
    """Switch-style load-balance loss ``E · Σ(me · pe)``."""
    t, e = r.probs.shape
    me = r.counts.to(torch.float32) / t
    pe = torch.mean(r.probs, dim=0)
    return e * torch.sum(me * pe)


def moe_chunk(p: Dict, xt: torch.Tensor, cfg, tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route one chunk of tokens. xt: (T, D) -> ((T, D), aux). With ``tp``
    the experts held here are this rank's E/M and the output is their
    partial sum (:func:`moe_parts`)."""
    r = route(p["router"], xt, cfg)
    if tp is None:
        return combine(experts(p, dispatch(xt, r), cfg.act), r), aux_loss(r)
    n_local = p["w_up"].shape[0]
    lo = tp.rank * n_local
    mine = (r.idx >= lo) & (r.idx < lo + n_local)
    # This rank's buffers: its experts' slots only (the others' choices go
    # to the spare row, as a dropped choice does).
    local = r._replace(idx=r.idx - lo, keep=r.keep & mine,
                       gates=copy_to_model(r.gates, tp) * mine,
                       probs=r.probs[:, lo:lo + n_local])
    xin = dispatch(copy_to_model(xt, tp), local)
    return combine(experts(p, xin, cfg.act), local), aux_loss(r)


def moe_chunk_plain(p: Dict, xt: torch.Tensor, cfg):
    """The reference's ``_moe_chunk`` line for line (float one-hot slot
    positions, dense (T, E, C) dispatch and combine einsums): the plain
    version of :func:`moe_chunk`. Returns (out, aux, idx, keep, xin)."""
    t, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    logits = (xt.to(torch.float32) @ p["router"]).to(torch.float32)     # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[:, :k], gate_idx[:, :k]              # (T, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    capacity = max(int(t * k / e * cfg.capacity_factor), 1)
    onehot = F.one_hot(gate_idx, e).to(torch.float32)                   # (T, k, E)
    flat = onehot.reshape(t * k, e)
    pos = (torch.cumsum(flat, dim=0) - flat).reshape(t, k, e)           # (T, k, E)
    pos = torch.sum(pos * onehot, dim=-1)                               # (T, k)
    keep = pos < capacity
    gate_vals = gate_vals * keep.to(gate_vals.dtype)

    dispatch_ = torch.zeros((t, e, capacity), dtype=torch.float32,
                            device=xt.device)
    combine_ = torch.zeros((t, e, capacity), dtype=torch.float32,
                           device=xt.device)
    for i in range(k):
        oh_e = onehot[:, i]                                             # (T, E)
        # pos >= capacity has no column: a zero row, as jax.nn.one_hot.
        oh_c = F.one_hot(torch.clamp(pos[:, i].long(), max=capacity),
                         capacity + 1)[:, :capacity].to(torch.float32)  # (T, C)
        d_i = (oh_e * keep[:, i:i + 1].to(torch.float32))[:, :, None] \
            * oh_c[:, None, :]
        dispatch_ = dispatch_ + d_i
        combine_ = combine_ + d_i * gate_vals[:, i][:, None, None]

    xin = torch.einsum("tec,td->ecd", dispatch_.to(xt.dtype), xt)      # (E, C, D)
    if cfg.act == "swiglu":
        h = F.silu(torch.einsum("ecd,edf->ecf", xin, p["w_gate"]))
        h = h * torch.einsum("ecd,edf->ecf", xin, p["w_up"])
    else:
        h = torch.einsum("ecd,edf->ecf", xin, p["w_up"])
        h = _gelu(h) if cfg.act == "gelu" else torch.square(F.relu(h))
    eout = torch.einsum("ecf,efd->ecd", h, p["w_down"])                 # (E, C, D)
    out = torch.einsum("tec,ecd->td", combine_.to(eout.dtype), eout)

    me = torch.mean(onehot.sum(1), dim=0)
    pe = torch.mean(probs, dim=0)
    aux = e * torch.sum(me * pe)
    return out, aux, gate_idx, keep, xin
