"""Vocab-safe losses.

Twin of :mod:`repro.models.losses`. ``chunked_cross_entropy`` never
materializes the (B, S, V) logits tensor: the sequence is walked in chunks,
each chunk computes its (B, C, V) fp32 logits, its log-sum-exp and its label
scores, and only the scalar sums survive. Under grad each chunk is
checkpointed (``torch.utils.checkpoint``): autograd keeps the chunk's hidden
rows and recomputes its logits in the backward, so the saved state does not
grow with the vocabulary (at internvl2-2b's V = 92,553 and 8192 tokens the
chunks' saved fp32 logits alone would be 16 x 512 x 92,553 x 4 B ~ 3.0 GB).

Vocabulary-parallel (``tp``, the unembedding's columns split over a model
group, as the sharding rules place ``unembed``): each rank computes its
slice of each chunk's logits; the row maximum is a detached ``MAX`` over
the group, and the sum of exponentials and the label's logit are each a
``reduce_from_model`` (the label's logit from the rank that holds it).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .parallel import copy_to_model, max_over_model, reduce_from_model


def _chunk_nll(h: torch.Tensor, unembed: torch.Tensor, y: torch.Tensor,
               m: torch.Tensor, tp=None) -> torch.Tensor:
    """sum((logsumexp - label score) * mask) of one (B, C) chunk."""
    if tp is None:
        logits = (h @ unembed).to(torch.float32)  # (B, C, V)
        lse = torch.logsumexp(logits, dim=-1)
        score = torch.gather(logits, -1, y[..., None])[..., 0]
        return torch.sum((lse - score) * m)
    logits = (copy_to_model(h, tp) @ unembed).to(torch.float32)  # (B, C, V/M)
    n = logits.shape[-1]
    top = max_over_model(torch.amax(logits.detach(), dim=-1), tp)
    sumexp = reduce_from_model(
        torch.sum(torch.exp(logits - top[..., None]), dim=-1), tp)
    lse = torch.log(sumexp) + top
    local = y - tp.rank * n
    mine = (local >= 0) & (local < n)
    score = torch.gather(logits, -1, torch.clamp(local, 0, n - 1)[..., None])
    score = reduce_from_model(torch.where(mine, score[..., 0], 0.0), tp)
    return torch.sum((lse - score) * m)


def chunked_cross_entropy(
    hidden: torch.Tensor,
    unembed: torch.Tensor,
    labels: torch.Tensor,
    mask: torch.Tensor,
    chunk: int = 512,
    tp=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-sum cross entropy.

    hidden: (B, S, D); unembed: (D, V) (or this rank's (D, V/M) with
    ``tp``); labels: (B, S) int; mask: (B, S) {0,1}. Returns fp32
    (sum_nll, n_tokens) so callers can combine across microbatches and
    workers before dividing. (The reference pads the last chunk with masked
    rows, which add exact zeros; here it is shorter.)
    """
    s = hidden.shape[1]
    labels = labels.long()
    mask = mask.to(torch.float32)
    grad = torch.is_grad_enabled() and (hidden.requires_grad
                                        or unembed.requires_grad)
    nll = torch.zeros((), dtype=torch.float32, device=hidden.device)
    ntok = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        part = (hidden[:, c0:c0 + chunk], unembed, labels[:, c0:c0 + chunk],
                mask[:, c0:c0 + chunk], tp)
        nll = nll + (checkpoint(_chunk_nll, *part, use_reentrant=False)
                     if grad else _chunk_nll(*part))
        ntok = ntok + torch.sum(part[3])
    return nll, ntok


def lm_loss(
    hidden: torch.Tensor,
    unembed: torch.Tensor,
    tokens: torch.Tensor,
    chunk: int = 512,
    loss_mask: Optional[torch.Tensor] = None,
    tp=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token LM loss from (B, S, D) hidden and (B, S) tokens.

    Predicts tokens[:, 1:] from hidden[:, :-1]. ``loss_mask`` (B, S) marks
    which *target* positions count (e.g. text-only targets for the VLM).
    """
    h = hidden[:, :-1]
    y = tokens[:, 1:]
    m = torch.ones(y.shape, dtype=torch.float32, device=hidden.device)
    if loss_mask is not None:
        m = m * loss_mask[:, 1:].to(torch.float32)
    nll, ntok = chunked_cross_entropy(h, unembed, y, m, chunk=chunk, tp=tp)
    return nll, {"n_tokens": ntok}
