"""build_model(cfg) -> ModelBundle: init / loss / prefill / decode.

Twin of :mod:`repro.models.model`. Batch schemas (``configs.shapes``):

  LM families (dense/moe/ssm/hybrid):
      {"tokens": (B, S) int}
  audio encoder (hubert; the conv frontend a stub):
      {"frames": (B, S, F) f32} (+ "labels": (B, S) int to train);
      "prefill" is one encoder forward (no decode)
  vlm (internvl2; the ViT a stub):
      {"patches": (B, P, F) f32, "tokens": (B, S-P) int}; the patch
      embeddings prefix the text, the loss counts text targets only

Parameters are the reference's nested dicts of arrays as dicts of tensors,
in the same layout and dtypes (the leaves the reference keeps in fp32 in a
bf16 model too: the MoE router, the ssm ``A_log``/``D``/``dt_bias``, the
rglru ``b_a``/``b_i``/``lam``); :func:`params_from_reference` carries a
reference tree (as numpy) across. ``loss_fn`` is differentiable with
autograd; the serving entry points take parameters that require no grad.

Model shards (``build_model(cfg, shards=ModelShards(...))``): ``init``
draws the whole tree's random stream, as one shard does, and keeps this
rank's cut (bitwise :func:`repro_torch.models.parallel.shard_params` of
the whole tree, which is never made), so every shard count trains and
serves the same weights; ``loss_fn``, ``prefill`` and ``decode_step`` run
the layers tensor-parallel over the model group (the embedding, the loss
and the logits vocabulary-parallel), the decode caches cut by the
reference's ``cache_shardings`` (``make_cache(..., shards=)``).

Data shards (``build_model(cfg, data=DataShards(...))``, the fsdp rules):
``init`` also keeps this rank's slice of each leaf the rules cut over data
(:func:`repro_torch.models.parallel.data_dims`), and ``loss_fn`` gathers
those leaves where they are read: each layer's when it runs
(:func:`repro_torch.models.transformer.stack_train`), the embedding and
unembedding at the lookup and the loss. Each rank's ``loss_fn`` runs its
own rows of a microbatch and counts the MoE load-balance term 1/D, so the
ranks' losses sum to the microbatch's. In serving the data group is the
batch's: each data index serves its rows of the batch every rank passes
(all of them when D does not divide it).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

from .layers import apply_norm, dense_init, dtype_of, empty, init_norm, normal_
from .losses import chunked_cross_entropy, lm_loss
from .parallel import (
    DataShards,
    ModelShards,
    at,
    cache_model_dims,
    data_dims_tree,
    gather_tree,
    init_cut,
    over,
    own_rows,
    reduce_from_model,
    shard_params,
)
from .transformer import (
    init_cache,
    init_stack,
    stack_decode,
    stack_layout,
    stack_prefill,
    stack_train,
    tree_leaves,
)

# The leaves the reference keeps in fp32 whatever ``param_dtype`` is, by the
# kind of layer whose temporal block holds them.
_FP32_LEAVES = {"ssm": ("A_log", "D", "dt_bias"),
                "rglru": ("b_a", "b_i", "lam")}


@dataclass
class ModelBundle:
    cfg: Any
    init: Callable         # (generator) -> params, on ``device``
    loss_fn: Callable      # (params, batch) -> (total, metrics dict)
    prefill: Callable      # (params, batch) -> (cache, last_logits)
    decode_step: Callable  # (params, cache, token, cache_pos) -> (cache, logits)
    device: torch.device
    embed_batch: Callable  # (params, batch) -> (x, loss_mask or None)
    shards: Optional[ModelShards] = None  # this rank's model group
    data: Optional[DataShards] = None     # this rank's data group


def _cut(tree, cfg, shards, data):
    """This rank's cut of a whole parameter tree over its groups."""
    if shards is None and data is None:
        return tree
    m = (1, 0) if shards is None else (shards.size, shards.rank)
    d = (1, 0) if data is None else (data.size, data.rank)
    return shard_params(tree, cfg, *m, *d)


def build_model(cfg, device=None, shards: Optional[ModelShards] = None,
                data: Optional[DataShards] = None) -> ModelBundle:
    """The bundle for ``cfg`` on ``device`` (CUDA unless named; raises
    without a GPU and no explicit device); ``shards``: this rank's model
    group, or None for the whole model on this process; ``data``: this
    rank's data group, when the leaves the rules cut over data rest cut
    (the fsdp step's layout), or None."""
    device = resolve_device(device)
    dt = dtype_of(cfg.param_dtype)
    if data is not None and data.size == 1:
        data = None
    dims = None if data is None else data_dims_tree(
        cfg, data.size, 1 if shards is None else shards.size)
    cut = None  # this rank's cut of every leaf, for init
    if shards is not None or data is not None:
        cut = init_cut(cfg, *((1, 0) if shards is None
                              else (shards.size, shards.rank)),
                       *((1, 0) if data is None else (data.size, data.rank)))

    def init(generator: torch.Generator) -> Dict:
        """Random weights from ``generator`` (on ``device``), every leaf
        allocated on the device in ``cfg.param_dtype`` (the reference's fp32
        leaves in fp32); with ``shards`` or ``data``, this rank's cut of
        them, bitwise :func:`repro_torch.models.parallel.shard_params` of
        the whole tree: each leaf's draws are made whole, a chunk at a time,
        and only this rank's elements kept (no whole leaf is allocated)."""
        return draw(generator, cut)

    def draw(generator: torch.Generator, cut) -> Dict:
        embed = empty((cfg.vocab_size, cfg.d_model), dt, device,
                      at(cut, "embed"))
        p: Dict[str, Any] = {
            "embed": normal_(embed, generator, 0.02, at(cut, "embed")),
            "stack": init_stack(generator, cfg, device, at(cut, "stack")),
            "final_norm": init_norm(cfg.d_model, cfg.norm, dt, device,
                                    cut=at(cut, "final_norm")),
        }
        if not cfg.tie_embeddings:
            p["unembed"] = dense_init(generator, cfg.d_model, cfg.vocab_size,
                                      dt, scale=0.02, device=device,
                                      cut=at(cut, "unembed"))
        if cfg.frontend:
            p["frontend_proj"] = dense_init(generator, cfg.frontend_dim,
                                            cfg.d_model, dt, device=device,
                                            cut=at(cut, "frontend_proj"))
        return p

    def leaf(params, key):
        """``params[key]``, gathered over the data group where it is cut."""
        return gather_tree(params[key], None if dims is None else dims[key],
                           data)

    def unembed_of(params):
        if cfg.tie_embeddings:
            return leaf(params, "embed").T
        return leaf(params, "unembed")

    def embed(params, tokens) -> torch.Tensor:
        """The embedding rows of ``tokens``; vocabulary-parallel when the
        table is this rank's slice: ids outside it give zero rows, and the
        ranks' rows are summed (exactly: one is nonzero)."""
        tokens = torch.as_tensor(tokens, device=device).long()
        table = leaf(params, "embed")
        vtp = over(shards, table.shape[0], cfg.vocab_size)
        if vtp is None:
            return table[tokens]
        n = table.shape[0]
        local = tokens - vtp.rank * n
        mine = (local >= 0) & (local < n)
        rows = table[torch.clamp(local, 0, n - 1)]
        return reduce_from_model(torch.where(mine[..., None], rows, 0), vtp)

    def features(a) -> torch.Tensor:
        return torch.as_tensor(a, device=device).to(dt)

    def embed_batch(params, batch) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """-> (x (B, S, D), the loss mask (B, S) or None)."""
        if cfg.frontend == "audio_frames":
            return features(batch["frames"]) @ leaf(params, "frontend_proj"), \
                None
        if cfg.frontend == "vision_patches":
            xt = embed(params, batch["tokens"])
            xv = features(batch["patches"]) @ leaf(params, "frontend_proj")
            mask = torch.cat([
                torch.zeros(xv.shape[:2], dtype=torch.float32, device=device),
                torch.ones(xt.shape[:2], dtype=torch.float32, device=device)],
                dim=1)
            return torch.cat([xv, xt], dim=1), mask
        return embed(params, batch["tokens"]), None

    def loss_fn(params, batch):
        """(total, metrics): the summed token NLL plus ``0.01 · aux`` (the
        MoE load-balance loss; 0 without experts) where any token counts;
        metrics ``n_tokens`` and ``aux_loss`` (with ``data``, the aux
        term counts 1/D here: this rank's share of the microbatch's)."""
        x, loss_mask = embed_batch(params, batch)
        positions = torch.arange(x.shape[1], device=device)
        h, aux = stack_train(params["stack"], x, cfg, positions, shards,
                             data, None if dims is None else dims["stack"])
        h = apply_norm(leaf(params, "final_norm"), h, cfg.norm)
        unembed = unembed_of(params)
        vtp = over(shards, unembed.shape[-1], cfg.vocab_size)
        if cfg.decoder:
            tokens = torch.as_tensor(batch["tokens"], device=device).long()
            if cfg.frontend == "vision_patches":
                # Zero tokens under the patches; the mask drops them.
                tokens = torch.cat([tokens.new_zeros(
                    batch["patches"].shape[:2]), tokens], dim=1)
            nll, m = lm_loss(h, unembed, tokens, chunk=cfg.loss_chunk,
                             loss_mask=loss_mask, tp=vtp)
        else:
            labels = torch.as_tensor(batch["labels"], device=device).long()
            mask = torch.ones(labels.shape, dtype=torch.float32, device=device)
            nll, ntok = chunked_cross_entropy(h, unembed, labels, mask,
                                              chunk=cfg.loss_chunk, tp=vtp)
            m = {"n_tokens": ntok}
        m = dict(m, aux_loss=aux)
        n = m["n_tokens"]
        share = 0.01 if data is None else 0.01 / data.size
        total = nll + share * aux * n / torch.clamp(n, min=1.0)
        return total, m

    def sharded(b: int, length: Optional[int]):
        """The keywords of the stack's serving functions over the groups
        for a batch of ``b`` rows and a cache of ``length`` positions: the
        model group, the data group and its dims, the cache's model dims
        (:func:`repro_torch.models.parallel.cache_model_dims`), and whether
        each data index serves its own rows (:func:`own_rows`)."""
        if shards is None and data is None:
            return {}
        cdims = None
        if shards is not None and shards.size > 1:
            if length is None:
                raise ValueError("decode over model shards needs cache_len, "
                                 "the cache's positions")
            cdims = cache_model_dims(cfg, b, length, shards.size)
        return {"tp": shards, "dp": data,
                "dims": None if dims is None else dims["stack"],
                "cdims": cdims, "row_cut": own_rows(b, data) is not None}

    def rows_of(batch, b: int):
        sl = own_rows(b, data)
        return batch if sl is None else {k: v[sl] for k, v in batch.items()}

    def prefill(params, batch):
        """(cache, last_logits) of any of the three schemas; for an encoder
        the one forward (its caches as the reference builds them). Over
        the groups every rank passes the whole batch: a data index serves
        its rows (its 1/D when D divides them, else all), the cache comes
        back this rank's cut (the reference's ``cache_shardings``) and the
        logits are its rows' over its slice of the vocabulary (the
        unembedding's cut, the reference's ``(dp, "model")``)."""
        b = next(iter(batch.values())).shape[0]
        x, _ = embed_batch(params, rows_of(batch, b))
        positions = torch.arange(x.shape[1], device=device)
        h, cache = stack_prefill(params["stack"], x, cfg, positions,
                                 **sharded(b, x.shape[1]))
        h = apply_norm(leaf(params, "final_norm"), h, cfg.norm)
        logits = (h[:, -1] @ unembed_of(params)).to(torch.float32)
        return cache, logits

    def decode_step(params, cache, token, cache_pos,
                    cache_len: Optional[int] = None):
        """One token (B, 1) at position ``cache_pos``; ``cache`` is updated
        in place and returned. Over the groups every rank passes the whole
        batch's tokens and its cut of the cache, as :func:`prefill` gives
        it; ``cache_len`` (over a model group): the cache's positions,
        ``make_cache``'s ``max_len``."""
        token = torch.as_tensor(token, device=device)
        b = token.shape[0]
        sl = own_rows(b, data)
        x = embed(params, token if sl is None else token[sl])  # (B, 1, D)
        h, cache = stack_decode(params["stack"], x, cache, cache_pos, cfg,
                                **sharded(b, cache_len))
        h = apply_norm(leaf(params, "final_norm"), h, cfg.norm)
        logits = (h[:, 0] @ unembed_of(params)).to(torch.float32)
        return cache, logits

    return ModelBundle(cfg, init, loss_fn, prefill, decode_step, device,
                       embed_batch, shards, data)


def make_cache(cfg, batch: int, max_len: int, device=None,
               shards: Optional[ModelShards] = None,
               data: Optional[DataShards] = None):
    """The decode cache for ``batch`` rows of up to ``max_len`` positions;
    with ``shards`` or ``data``, zeros of this rank's cut of it alone."""
    m = (1, 0) if shards is None else (shards.size, shards.rank)
    d = (1, 0) if data is None else (data.size, data.rank)
    return init_cache(cfg, batch, max_len, resolve_device(device), *m, *d)


def param_count(params) -> int:
    return int(sum(t.numel() for t in tree_leaves(params)))


def _tensor(a) -> torch.Tensor:
    """A writable copy of array ``a`` as a host tensor of the same dtype."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_reference(tree, cfg, device=None,
                          shards: Optional[ModelShards] = None,
                          data: Optional[DataShards] = None) -> Dict:
    """The reference's params (``jax.tree.map(np.asarray, params)``) as the
    port's tree on ``device``, leaf for leaf with the same dtypes (with
    ``shards`` or ``data``, this rank's cut, as ``init`` gives it). Raises if
    a leaf is not in ``cfg.param_dtype``, except the leaves the reference
    keeps in fp32: an MoE ``router``, and the fp32 leaves of an ssm or
    rglru layer's temporal block (:data:`_FP32_LEAVES`)."""
    device = resolve_device(device)
    dt = dtype_of(cfg.param_dtype)
    _, extra_kinds = stack_layout(cfg)
    kinds = {"blocks": list(cfg.layer_pattern), "extras": extra_kinds}

    def want(path):
        key = path[-1]
        if key == "router" and cfg.is_moe:
            return torch.float32
        if len(path) == 5 and path[0] == "stack" and path[3] == "temporal":
            kind = kinds[path[1]][path[2]]
            if key in _FP32_LEAVES.get(kind, ()):
                return torch.float32
        return dt

    def carry(node, path=()):
        if isinstance(node, dict):
            return {k: carry(node[k], path + (k,)) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(carry(v, path + (i,))
                              for i, v in enumerate(node))
        if node is None:
            return None
        t = _tensor(node)
        if t.dtype != want(path):
            raise ValueError(f"leaf {'/'.join(map(str, path))} of dtype "
                             f"{t.dtype}, want {want(path)}")
        return t.to(device)

    return _cut(carry(tree), cfg, shards, data)
