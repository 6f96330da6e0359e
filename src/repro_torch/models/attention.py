"""GQA attention: init, chunked (flash-style) long-sequence path, cached decode.

Twin of :mod:`repro.models.attention`, same names and layouts (activations
(B, S, H, hd)). Three execution paths, one semantics (==
kernels/ref.attention_ref):

  * long sequences (``s > cfg.attn_chunk``): on a CUDA tensor the
    hand-written flash kernel (``kernels.ops.flash_attention``); on a host
    tensor ``chunked_attention``, the reference's online-softmax scan over
    KV blocks in plain PyTorch. The two compute the same function: the
    kernel's causal offset ``skv - sq`` is the scan's ``q_offset = 0`` when
    ``sq == skv``. Training differentiates the kernel route through
    :class:`FlashAttentionFn`: the kernel forward, and a backward that
    recomputes ``chunked_attention`` and backpropagates through it (the
    reference's ``jax.checkpoint`` of the scan).
  * plain quadratic attention with fp32 accumulation (``full_attention``) —
    decode (sq == 1) and short sequences, on any device, as the reference
    computes it outside any kernel.

The decode cache is updated in place (slice assignment where the reference
returns a ``dynamic_update_slice`` copy): the returned cache holds the same
tensors as the one passed in.

Over model shards (:func:`attention_parts`, :func:`attention_prefill_parts`,
:func:`attention_decode_parts`) each rank holds its columns of the
projections and its cut of the cache by the reference's
``cache_shardings``; over a cut of the cache's slots the decode is
flash-decoding's split-K (:func:`split_k_attention`), the collectives GSPMD
inserts in the reference written out.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops

from .layers import dense_init, dtype_of, full, rope
from .parallel import at

NEG_INF = -1e30


def init_attention(generator, cfg, device=None, lead=(), cut=None) -> Dict:
    d, hd = cfg.d_model, cfg.head_dim
    dt = dtype_of(cfg.param_dtype)
    shapes = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
              "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d)}
    p = {n: dense_init(generator, *shp, dt, device=device, lead=lead,
                       cut=at(cut, n))
         for n, shp in shapes.items()}
    if cfg.qkv_bias:
        for n, width in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                         ("bv", cfg.n_kv_heads)):
            p[n] = full(tuple(lead) + (width * hd,), 0.0, dt, device,
                        at(cut, n))
    return p


def qkv(p: Dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,Hk,hd), RoPE applied."""
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    chunk: int = 1024,
    q_chunk: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Online-softmax attention, blocked over BOTH query and KV axes.

    q: (B, Sq, H, hd); k/v: (B, Skv, Hk, hd) with Hk | H. ``q_offset`` is the
    kv-position of q's first row (Skv - Sq for aligned trailing queries).
    The plain version of the long-sequence path: the reference's scan in
    PyTorch, op for op (a full-length masked KV scan per query chunk).
    Returns (B, Sq, H, hd).
    """
    b, sq, h, hd = q.shape
    skv, hk = k.shape[1], k.shape[2]
    grp = h // hk
    scale = hd ** -0.5
    qc = min(q_chunk or chunk, sq)
    nq = -(-sq // qc)
    nkv = -(-skv // chunk)
    dev = q.device

    qp = F.pad(q, (0, 0, 0, 0, 0, nq * qc - sq))
    kp = F.pad(k, (0, 0, 0, 0, 0, nkv * chunk - skv))
    vp = F.pad(v, (0, 0, 0, 0, 0, nkv * chunk - skv))
    kp = kp.reshape(b, nkv, chunk, hk, hd).permute(1, 0, 3, 2, 4)  # (n,b,hk,c,hd)
    vp = vp.reshape(b, nkv, chunk, hk, hd).permute(1, 0, 3, 2, 4)
    # (nq, b, hk, grp, qc, hd)
    qs = qp.reshape(b, nq, qc, hk, grp, hd).permute(1, 0, 3, 4, 2, 5)

    outs = []
    for qi in range(nq):
        qg = qs[qi].to(torch.float32)
        q_pos = q_offset + qi * qc + torch.arange(qc, device=dev)
        m = torch.full((b, hk, grp, qc, 1), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, hk, grp, qc, 1), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hk, grp, qc, hd), dtype=torch.float32,
                          device=dev)
        for ci in range(nkv):
            kc = kp[ci].to(torch.float32)
            vc = vp[ci].to(torch.float32)
            s = torch.einsum("bkgqd,bkcd->bkgqc", qg, kc) * scale
            k_pos = ci * chunk + torch.arange(chunk, device=dev)
            mask = (k_pos < skv)[None, :].expand(qc, chunk)
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            if window is not None:
                mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
            pexp = torch.where(mask, torch.exp(s - m_new), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + torch.sum(pexp, dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bkgqc,bkcd->bkgqd", pexp, vc)
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30))
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(b, nq * qc, h, hd)
    return out[:, :sq].to(q.dtype)


def _flash(q, k, v, causal: bool, window: Optional[int]):
    """``kernels.ops.flash_attention`` on (B, S, H, hd) activations, read in
    place through a (B, H, S, hd) view."""
    o = kernel_ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, scale=q.shape[-1] ** -0.5)
    return o.transpose(1, 2)


class FlashAttentionFn(torch.autograd.Function):
    """The flash kernel with a gradient. Forward: :func:`_flash` (no graph).
    Backward: :func:`chunked_attention` recomputed from the saved q, k, v
    under grad and backpropagated, one query chunk of ``chunk`` rows at a
    time (the scan treats its query chunks independently, so each chunk's
    graph, at most ``chunk`` x ``skv`` scores per head, is all that lives at
    once). This is the reference's scheme for ``s > attn_chunk``: it
    wraps the scan in ``jax.checkpoint``; the JAX package has no backward
    kernel. (B, S, H, hd) in and out."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int],
                chunk: int):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window, ctx.chunk = causal, window, chunk
        return _flash(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        sq, skv = q.shape[1], k.shape[1]
        off = skv - sq  # the kernel's causal alignment
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        dq = torch.empty_like(q)
        dk = torch.zeros_like(k, dtype=torch.float32)
        dv = torch.zeros_like(v, dtype=torch.float32)
        with torch.enable_grad():
            for q0 in range(0, sq, ctx.chunk):
                q_i = q[:, q0:q0 + ctx.chunk]
                o_i = chunked_attention(q_i, k, v, causal=ctx.causal,
                                        window=ctx.window, chunk=ctx.chunk,
                                        q_offset=off + q0)
                g_q, g_k, g_v = torch.autograd.grad(
                    o_i, (q_i, k, v), grad[:, q0:q0 + ctx.chunk])
                dq[:, q0:q0 + ctx.chunk] = g_q
                dk += g_k
                dv += g_v
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None


def long_attention(q, k, v, causal: bool, window: Optional[int], chunk: int):
    """The ``s > attn_chunk`` branch: the flash kernel for CUDA tensors
    (through :class:`FlashAttentionFn`, which gives it a gradient when one
    is needed; a meta tensor, the dry-run's card tensor, too),
    :func:`chunked_attention` for host tensors. (B, S, H, hd) in and out."""
    if not kernel_ops.card_route(None, q):
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 chunk=chunk)
    return FlashAttentionFn.apply(q, k, v, causal, window, chunk)


def full_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Quadratic attention with an explicit (B?, Sq, Skv) bool mask (decode).

    Scores and the weighted sum accumulate in fp32, as the reference's
    ``preferred_element_type``; the probabilities are rounded to v's dtype
    before the weighted sum, as there.
    """
    b, sq, h, hd = q.shape
    hk = k.shape[2]
    grp = h // hk
    scale = hd ** -0.5
    qg = q.reshape(b, sq, hk, grp, hd)
    s = torch.einsum("bqkgd,bckd->bkgqc", qg.to(torch.float32),
                     k.to(torch.float32)) * scale
    if mask is not None:
        while mask.ndim < s.ndim:
            mask = mask[:, None]
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqc,bckd->bqkgd", p.to(v.dtype).to(torch.float32),
                     v.to(torch.float32))
    return o.reshape(b, sq, h, hd).to(q.dtype)


def _square_mask(s: int, causal: bool, window: Optional[int], device):
    q_pos = torch.arange(s, device=device)
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= q_pos[None, :] > q_pos[:, None] - window
    return mask


def attention_train(
    p: Dict, x: torch.Tensor, cfg, positions: torch.Tensor,
    window: Optional[int] = None, causal: bool = True,
    attn_impl: str = "chunked",
) -> torch.Tensor:
    """Self-attention over a full sequence (training and prefill).

    ``attn_impl="pallas"`` is the reference's kernel route: here
    ``kernels.ops.flash_attention`` at every length (the kernel on CUDA, its
    plain version on the host; like the reference's, the kernel route has
    no gradient, and on CUDA it raises under grad). ``"chunked"`` takes
    :func:`long_attention` above ``cfg.attn_chunk`` (differentiable on
    either device) and :func:`full_attention` otherwise. (Over model
    shards: :func:`attention_parts`.)
    """
    return attention_parts(p, x, cfg, positions, window, causal,
                           attn_impl)[1]


def _attend(q, k, v, cfg, window, causal, attn_impl):
    b, s = q.shape[:2]
    if attn_impl == "pallas":
        o = _flash(q, k, v, causal, window)
    elif attn_impl == "chunked" and s > cfg.attn_chunk:
        o = long_attention(q, k, v, causal, window, cfg.attn_chunk)
    else:
        o = full_attention(q, k, v, _square_mask(s, causal, window,
                                                 q.device)[None])
    return o.reshape(b, s, -1)


def _kv_for_heads(k, v, heads, grp):
    """K and V for the query heads ``heads`` (kv head ``h // grp`` each):
    the kv heads they read, each once, when the heads fall into equal runs
    per kv head (so attention's GQA grouping holds); else one per query
    head."""
    kv = [h // grp for h in heads]
    uniq = sorted(set(kv))
    run = len(heads) // len(uniq)
    if kv == [u for u in uniq for _ in range(run)]:
        return k[:, :, uniq[0]:uniq[-1] + 1], v[:, :, uniq[0]:uniq[-1] + 1]
    idx = torch.tensor(kv, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def attention_parts(p: Dict, x: torch.Tensor, cfg, positions: torch.Tensor,
                    window: Optional[int] = None, causal: bool = True,
                    attn_impl: str = "chunked", tp=None, kv: bool = False):
    """(partial, whole) of :func:`attention_train`; with ``kv``, also the
    layer's whole K and V (B, S, Hk, hd) after RoPE, for a cache.

    With ``tp`` (a :class:`repro_torch.models.parallel.ModelShards`) each
    projection whose columns the sharding rules split (``wq``/``wk``/``wv``
    and their biases by column, ``wo`` by row) holds this rank's slice:
      * query heads aligned (``n_heads % M == 0``): this rank attends over
        its H/M query heads and its ``wo`` rows give a partial sum. K and V
        are this rank's own heads when ``n_kv_heads % M == 0``; otherwise
        (a split through a head, as glm4-9b's 2 x 128 over 4) they are
        gathered whole and each local query head reads kv head
        ``h // (H / Hk)``.
      * query heads not aligned (the ``wq`` split crosses a head, as
        recurrentgemma-2b's 10 heads over 4): q, k and v are gathered
        whole, every rank attends over all heads, and takes its columns of
        the output before its ``wo`` rows.
    RoPE runs on whole heads, after any gather.
    """
    from .parallel import (
        copy_to_model,
        gather_from_model,
        over,
        slice_to_model,
    )

    b, s, _ = x.shape
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qtp = over(tp, p["wq"].shape[-1], h * hd)
    ktp = over(tp, p["wk"].shape[-1], hk * hd)
    if qtp is None and ktp is None:
        q, k, v = qkv(p, x, cfg, positions)
        out = None, _attend(q, k, v, cfg, window, causal, attn_impl) @ p["wo"]
        return (out, (k, v)) if kv else out
    x_tp = copy_to_model(x, tp)

    def proj(w, bias, split):
        y = (x_tp if split else x) @ p[w]
        return y + p[bias] if cfg.qkv_bias else y

    q = proj("wq", "bq", qtp is not None)
    k = proj("wk", "bk", ktp is not None)
    v = proj("wv", "bv", ktp is not None)
    aligned = qtp is not None and h % tp.size == 0
    own_kv = aligned and ktp is not None and hk % tp.size == 0
    if not own_kv:
        k, v = (gather_from_model(t, ktp) for t in (k, v))
        if aligned:  # local heads read the whole K, V: partial gradients
            k, v = copy_to_model(k, tp), copy_to_model(v, tp)
    if not aligned:
        q = gather_from_model(q, qtp)
    q = rope(q.reshape(b, s, -1, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(b, s, -1, hd), positions, cfg.rope_theta)
    v = v.reshape(b, s, -1, hd)
    whole_kv = (k, v)
    if own_kv and kv:
        whole_kv = tuple(gather_from_model(t, tp, 2) for t in (k, v))
    if aligned and not own_kv:
        hl = h // tp.size
        k, v = _kv_for_heads(k, v, range(tp.rank * hl, (tp.rank + 1) * hl),
                             h // hk)
    o = _attend(q, k, v, cfg, window, causal, attn_impl)
    if qtp is None:
        out = None, o @ p["wo"]
    else:
        if not aligned:
            o = slice_to_model(o, tp)
        out = o @ p["wo"], None
    return (out, whole_kv) if kv else out


def attention_prefill(
    p: Dict, x: torch.Tensor, cfg, positions: torch.Tensor,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence forward that also materializes the KV cache.

    Returns (out (B,S,D), cache). For windowed layers the cache is the ring
    buffer holding the trailing ``window`` positions (slot = pos % window),
    consistent with :func:`attention_decode`. (Over model shards:
    :func:`attention_prefill_parts`.)
    """
    parts, cache = attention_prefill_parts(p, x, cfg, positions, window)
    return parts[1], cache


def attention_prefill_parts(p: Dict, x: torch.Tensor, cfg,
                            positions: torch.Tensor,
                            window: Optional[int] = None, tp=None,
                            kv_dim: Optional[int] = None):
    """((partial, whole), cache) of :func:`attention_prefill` over the
    model group ``tp`` (:func:`attention_parts`: on the card the flash
    kernel runs on this rank's query heads when they are aligned). The
    cache is this rank's cut of the whole one: ``kv_dim`` (counted from the
    end: -3 the slots, -2 the heads, -1 the head dim; None whole) is the
    dim the reference's ``cache_shardings`` puts on ``"model"``. A windowed
    layer's ring buffer is laid out whole and then cut."""
    from .parallel import own_slice

    parts, (k, v) = attention_parts(p, x, cfg, positions, window,
                                    causal=cfg.decoder, tp=tp, kv=True)
    s = x.shape[1]
    if window:
        slots = min(window, s)
        # ring layout: position p -> slot p % slots; take trailing `slots`.
        roll = (s - slots) % slots
        k = torch.roll(k[:, -slots:], shifts=roll, dims=1)
        v = torch.roll(v[:, -slots:], shifts=roll, dims=1)
    if kv_dim is not None:
        k, v = own_slice(k, tp, kv_dim), own_slice(v, tp, kv_dim)
    return parts, {"k": k, "v": v}


# ---------------------------------------------------------------------- #
# Cached decode
# ---------------------------------------------------------------------- #
def init_kv_cache(cfg, batch: int, max_len: int, window: Optional[int] = None,
                  device=None, lead=()) -> Dict:
    dt = dtype_of(cfg.param_dtype)
    slots = min(window, max_len) if window else max_len
    shape = tuple(lead) + (batch, slots, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def attention_decode(
    p: Dict, x: torch.Tensor, cache: Dict, cache_pos, cfg,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict]:
    """One-token decode. x: (B, 1, D); cache_pos: int = tokens so far.

    Ring-buffer semantics when ``window`` is set (slot = pos % window; RoPE is
    applied at write time with absolute positions, so relative geometry
    survives the ring). The new K/V row is written into ``cache`` in place.
    (Over model shards: :func:`attention_decode_parts`.)
    """
    parts, cache = attention_decode_parts(p, x, cache, cache_pos, cfg, window)
    return parts[1], cache


def _valid_slots(idx: torch.Tensor, pos: int, slots: int,
                 window: Optional[int]) -> torch.Tensor:
    """Which of the (global) slots ``idx`` of a ``slots``-slot cache hold a
    position once position ``pos`` is written."""
    if window:
        # Slot i last written at p_i = pos - ((pos - i) mod slots).
        return pos - torch.remainder(pos - idx, slots) >= 0
    return idx <= pos


def split_k_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      valid: torch.Tensor, tp) -> torch.Tensor:
    """:func:`full_attention` of every query head against a cache whose
    slots are cut over the model group (flash-decoding's split-K): each
    rank scores its stripe ``k``/``v`` (B, S/M, Hk, hd) where ``valid``
    (S/M,) holds. The row maximum and the softmax sum are reduced over the
    group first (fp32), then each rank rounds its probabilities to ``v``'s
    dtype, as one card does after its softmax, and the partial outputs are
    summed in fp32: one card's rounding, up to the sum order."""
    from .parallel import max_over_model, reduce_from_model

    b, sq, h, hd = q.shape
    hk = k.shape[2]
    qg = q.reshape(b, sq, hk, h // hk, hd)
    s = torch.einsum("bqkgd,bckd->bkgqc", qg.to(torch.float32),
                     k.to(torch.float32)) * hd ** -0.5
    s = torch.where(valid, s, NEG_INF)
    m = max_over_model(torch.amax(s, dim=-1, keepdim=True), tp)
    e = torch.exp(s - m)
    p = e / reduce_from_model(torch.sum(e, dim=-1, keepdim=True), tp)
    o = torch.einsum("bkgqc,bckd->bqkgd", p.to(v.dtype).to(torch.float32),
                     v.to(torch.float32))
    return reduce_from_model(o, tp).reshape(b, sq, h, hd).to(q.dtype)


def attention_decode_parts(p: Dict, x: torch.Tensor, cache: Dict, cache_pos,
                           cfg, window: Optional[int] = None, tp=None,
                           kv_dim: Optional[int] = None):
    """((partial, whole), cache) of :func:`attention_decode` over the model
    group ``tp``, the cache this rank's cut (``kv_dim`` as in
    :func:`attention_prefill_parts`). The token's q, k and v are
    made whole on every rank (their split projections gathered). The slot
    of the new position is the one card's, ``dynamic_update_slice``'s clamp
    to the last slot included, and only the rank holding it writes it (its
    own heads or head dims of it for those cuts). Over a slot cut the
    attention is :func:`split_k_attention` with each slot's validity read
    from its global index; over a head or head-dim cut this rank's cut of
    the layer is gathered whole for the step. The output leaves through
    ``wo``'s rows: a partial sum when they are split."""
    from .parallel import gather_from_model, over, slice_to_model

    if tp is None or tp.size == 1:  # one shard: the cache is whole
        tp, kv_dim = None, None
    b = x.shape[0]
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = int(cache_pos)
    local = cache["k"].shape[1]
    slots = local * tp.size if kv_dim == -3 else local  # the whole cache's
    positions = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)

    def proj(w, bias, width):
        y = x @ p[w]
        y = y + p[bias] if cfg.qkv_bias else y
        y = gather_from_model(y, over(tp, p[w].shape[-1], width))
        return y.reshape(b, 1, -1, hd)

    q = rope(proj("wq", "bq", h * hd), positions, cfg.rope_theta)
    k = rope(proj("wk", "bk", hk * hd), positions, cfg.rope_theta)
    v = proj("wv", "bv", hk * hd)
    slot = min(pos % slots if window else pos, slots - 1)
    if kv_dim == -3:
        lo = tp.rank * local
        if lo <= slot < lo + local:
            cache["k"][:, slot - lo: slot - lo + 1] = k
            cache["v"][:, slot - lo: slot - lo + 1] = v
        valid = _valid_slots(lo + torch.arange(local, device=x.device), pos,
                             slots, window)
        o = split_k_attention(q, cache["k"], cache["v"], valid, tp)
    else:
        if kv_dim is not None:
            n = cache["k"].shape[kv_dim]
            k, v = (t.narrow(kv_dim, tp.rank * n, n) for t in (k, v))
        cache["k"][:, slot: slot + 1] = k
        cache["v"][:, slot: slot + 1] = v
        kw, vw = cache["k"], cache["v"]
        if kv_dim is not None:
            kw, vw = (gather_from_model(t, tp, kv_dim) for t in (kw, vw))
        valid = _valid_slots(torch.arange(slots, device=x.device), pos, slots,
                             window)
        o = full_attention(q, kw, vw, valid[None, None, :])
    o = o.reshape(b, 1, -1)
    wtp = over(tp, p["wo"].shape[-2], h * hd)
    if wtp is None:
        return (None, o @ p["wo"]), cache
    return (slice_to_model(o, wtp) @ p["wo"], None), cache
