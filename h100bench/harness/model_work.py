"""The least work of a decoder's forward pass whatever implements it,
counted from a configuration file's ``widths`` and never from the program.

A forward pass takes ``tokens`` new positions, the last of which sits at
position ``context - 1`` (so ``context`` counts the positions cached
before them plus the new ones), and computes the logits of
``logit_positions`` of them. Per layer of kind ``attn`` (global, causal)
or ``lattn`` (causal within ``window``):

- projections: 2 flops a parameter of Q, K, V and O (and their biases
  where ``qkv_bias``) a token;
- attention: 4 * ``head_dim`` flops (2 for Q.K, 2 for P.V) a live
  (query, key) pair a query head (:func:`causal_pairs`);
- FFN: 2 flops a parameter a token, with 3 matrices for a gated ``act``
  (``swiglu``, ``geglu``) and 2 otherwise. A MoE layer holds all its
  ``n_experts`` routed experts: its router is ``n_experts`` wide, and
  each token runs ``n_shared_experts`` and ``top_k`` routed experts;
- the LM head: 2 * ``d_model`` * ``vocab_size`` flops a logit position.

Bytes: each weight read once in ``dtype`` (the embedding only as the
rows of the new tokens; of the routed experts only the ``top_k`` that
every token must use, the least any routing reads), the K/V of every
position the new tokens attend to read once, and the new tokens' K/V
written once. Inputs, activations, logits and the further experts that a
spread routing reads are left out: the count is a lower bound.

Layers without attention and an FFN (``rglru``, ``ssm``) and modality
front ends raise NotImplementedError until a cell needs them. No layer
is counted as a leading dense one (a published ``first_k_dense_replace``):
``configs.check`` refuses ``leading_dense``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

DTYPE_BYTES = {"bfloat16": 2, "float32": 4}
GATED = ("swiglu", "geglu")
ATTENTION = ("attn", "lattn")


def causal_pairs(tokens: int, context: int,
                 window: Optional[int] = None) -> int:
    """Live (query, key) pairs of one head: the query at position p sees
    keys max(0, p - window + 1) .. p, for p = context - tokens .. context
    - 1."""
    if not 0 < tokens <= context:
        raise ValueError(f"tokens {tokens} must be in 1 .. context {context}")
    lo, hi = context - tokens, context - 1
    w = window or context
    # Queries at p < w see p + 1 keys: the sum of lo + 1 .. last + 1.
    last = min(hi, w - 1)
    pairs = 0
    if lo <= last:
        pairs += (last + 1) * (last + 2) // 2 - lo * (lo + 1) // 2
    # The rest see w keys each.
    if hi >= w:
        pairs += w * (hi - max(lo, w) + 1)
    return pairs


def _keys_seen(tokens: int, context: int, window: Optional[int]) -> int:
    """Distinct positions the new tokens attend to."""
    return context if not window else min(context, tokens + window - 1)


def forward_parts(widths: Mapping, tokens: int, context: int,
                  logit_positions: int, dtype: str = "bfloat16"
                  ) -> Dict[str, Tuple[float, float]]:
    """(flops, bytes) of each part of one forward pass: ``embedding`` (the
    new tokens' rows and the norms), ``projections``, ``attention``,
    ``ffn``, ``head`` (module docstring)."""
    pattern = tuple(widths.get("layer_pattern", ("attn",)))
    if widths.get("frontend") or widths.get("ssm_state", 0) \
            or set(pattern) - set(ATTENTION):
        raise NotImplementedError(
            f"no count for layers {pattern} or a front end "
            f"{widths.get('frontend')!r} yet")
    b = DTYPE_BYTES[dtype]
    d, hd = widths["d_model"], widths["head_dim"]
    h, hk = widths["n_heads"], widths["n_kv_heads"]
    n_layers = widths["n_layers"]
    kinds = [pattern[i % len(pattern)] for i in range(n_layers)]

    proj = d * hd * (2 * h + 2 * hk)
    if widths.get("qkv_bias", False):
        proj += hd * (h + 2 * hk)
    kv_row = 2 * hk * hd                       # K and V of one position
    attn_flops = attn_bytes = 0
    for kind in kinds:
        window = widths.get("window") if kind == "lattn" else None
        attn_flops += 4 * hd * h * causal_pairs(tokens, context, window)
        attn_bytes += b * kv_row * (_keys_seen(tokens, context, window)
                                    + tokens)

    mats = 3 if widths.get("act", "swiglu") in GATED else 2
    experts = widths.get("n_experts", 0)
    if experts:
        # The router, and the experts a token runs.
        used = widths["top_k"] + widths["n_shared_experts"]
        ffn_weights = d * experts + used * mats * d * widths["moe_d_ff"]
    else:
        ffn_weights = mats * d * widths["d_ff"]
    ffn_flops = 2 * tokens * ffn_weights

    vocab = widths["vocab_size"]
    norms = (2 * n_layers + 1) * d
    head = d * vocab if logit_positions else 0
    embed = 0 if widths.get("tie_embeddings", False) and head \
        else d * min(tokens, vocab)
    return {
        "embedding": (0.0, float(b * (embed + norms))),
        "projections": (2.0 * tokens * proj * n_layers,
                        float(b * proj * n_layers)),
        "attention": (float(attn_flops), float(attn_bytes)),
        "ffn": (float(ffn_flops * n_layers),
                float(b * ffn_weights * n_layers)),
        "head": (2.0 * d * vocab * logit_positions, float(b * head)),
    }


def forward_work(widths: Mapping, tokens: int, context: int,
                 logit_positions: int, dtype: str = "bfloat16"
                 ) -> Tuple[float, float]:
    """(flops, bytes) of one forward pass: the sum of
    :func:`forward_parts`. Its least time is :func:`roofline.bound_ms` at
    ``roofline.BF16_FLOPS_PER_S``."""
    parts = forward_parts(widths, tokens, context, logit_positions, dtype)
    return (sum(f for f, _ in parts.values()),
            sum(n for _, n in parts.values()))

