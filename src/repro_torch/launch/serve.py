"""Model prefill + decode demo: the serving path of the model stack.

Twin of ``examples/decode_demo.py`` (which the reference's
``repro.launch.serve`` loads): build one of the ported architectures, draw
random weights from a seed, prefill a prompt batch from ``demo_batch``,
restage the prompt's cache into a full-length cache (KV leaves at the
start of the longer ones; the recurrent layers' fixed-shape conv and state
leaves whole), then run the greedy (or temperature) decode loop. A VLM's
prompt is its patch prefix and its text (``--prompt-len`` counts both, as
in the reference demo); decode is token-only. On a GPU every long-sequence
attention of the prefill runs the hand-written flash kernel. Not connected
to the elastic engine.

Over model shards (``--model-shards M`` under ``torch.distributed.run``,
a world of D x M ranks, rank ``d * M + m``): the weights and decode caches
are cut by the reference's sharding rules (the pure-DP archs serve with
the usec rules, as the reference's dry-run does), each data index serves
its rows, and every rank of a model group picks the same tokens; each rank
reports its prefill seconds, decode tokens/s, peak memory, flash launches
and its model group's bytes (rank 0 prints ``rank r of W: {...}`` lines).
``--layers N`` cuts the depth.

Run (on a machine with an NVIDIA GPU; ``--device cpu`` runs the plain
PyTorch versions on the host):
  python -m repro_torch.launch.serve --arch glm4-9b --batch 1 \\
      --prompt-len 8192 --gen-len 32
  python -m repro_torch.launch.serve --arch recurrentgemma-2b --batch 1 \\
      --prompt-len 8192 --gen-len 32
  python -m repro_torch.launch.serve --arch mamba2-370m --batch 1 \\
      --prompt-len 8192 --gen-len 32
  python -m repro_torch.launch.serve --arch internvl2-2b --batch 1 \\
      --prompt-len 8192 --gen-len 32
  python -m torch.distributed.run --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.serve --arch qwen1.5-110b --model-shards 4 \\
      --batch 1 --prompt-len 8192 --gen-len 32
"""

from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.configs import demo_batch, get_config
from repro_torch.models import build_model, make_cache
from repro_torch.models.transformer import tree_leaves


@dataclass
class Generation:
    tokens: torch.Tensor   # (B, gen_len) int64: prefill's pick, then decode's
    logits: torch.Tensor   # (rows, gen_len, vocab) fp32, the logits behind
                           # each pick of the rows this rank serves
    prefill_s: float       # cache allocation + prefill + restage, synchronized
    decode_s: float        # the decode loop, synchronized
    model_bytes: Optional[Dict[str, float]] = None  # over a model group:
                           # its bytes in the prefill and a decode step
    peak_bytes: Optional[Dict[str, int]] = None  # on a card: the largest
                           # allocated in the prefill (with its restage)
                           # and in the decode loop


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompt_length(batch: Dict) -> int:
    """The prompt's positions: a VLM's patch prefix plus its text."""
    n = batch["tokens"].shape[1]
    return n + batch["patches"].shape[1] if "patches" in batch else n


def restage(cache: Dict, pre: Dict, cfg, b: int, prompt_len: int,
            max_len: int, tp=None) -> None:
    """Write the prompt's cache ``pre`` into the positions it covers of
    ``cache`` (``make_cache(cfg, b, max_len)``), each this rank's cut over
    the model group ``tp``: where both cut a leaf alike (or neither cuts
    it) its prefix is copied; where they differ (the K/V slots, cut over
    different lengths) each layer of ``pre`` is gathered whole along its
    cut and this rank's range of it copied, one layer at a time."""
    from repro_torch.models.parallel import cache_model_dims, gather_dim

    n = 1 if tp is None else tp.size
    full_dims = cache_model_dims(cfg, b, max_len, n)
    pre_dims = cache_model_dims(cfg, b, prompt_len, n)

    def prefix(dst, src):
        dst[tuple(slice(0, s) for s in src.shape)] = src

    def place(dst, src, d, e):  # one layer; dims counted from the end
        if e is not None:
            src = gather_dim(src, tp, e)
        if d is not None:
            k = dst.shape[d]
            lo = tp.rank * k
            hi = min(lo + k, src.shape[d])
            if hi <= lo:
                return
            src = src.narrow(d, lo, hi - lo)
        prefix(dst, src)

    def leaf(dst, src, d, e, stacked):
        if d == e and (d is None or dst.shape[d] == src.shape[e]):
            prefix(dst, src)
        elif stacked:
            for i in range(dst.shape[0]):
                place(dst[i], src[i], d, e)
        else:
            place(dst, src, d, e)

    for group, stacked in (("blocks", True), ("extras", False)):
        for j, layer in enumerate(cache[group]):
            for k in layer or ():
                leaf(layer[k], pre[group][j][k], full_dims[group][j][k],
                     pre_dims[group][j][k], stacked)


@torch.no_grad()
def generate(bundle, params, batch: Dict, gen_len: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             track_peaks: bool = False) -> Generation:
    """Prefill the prompt of ``batch`` (B, P positions: the tokens, after a
    VLM's patches), restage its cache into a ``make_cache(cfg, B, P +
    gen_len)`` cache (made after the prefill), and decode ``gen_len - 1`` more tokens: greedy at
    ``temperature == 0`` (ties to the lowest index, ``torch.argmax``),
    else sampled from ``softmax(logits / temperature)`` with
    ``generator``. Runs without autograd.

    Over the bundle's groups every rank passes the whole batch: each data
    index prefills and decodes its rows (:func:`repro_torch.models.parallel.own_rows`),
    the caches are this rank's cut, and the logits are gathered whole over
    the model group for the pick, so every rank of a group picks the same
    token (sampling too, with a generator seeded alike on every rank); the
    data indices' picks are gathered into the next step's whole batch.
    ``track_peaks`` (on a card): reset the allocator's peak before the
    prefill and before the decode loop, and report each part's."""
    from repro_torch.models.parallel import gather_dim, gather_from_model, over

    cfg, device = bundle.cfg, bundle.device
    tp, dp = bundle.shards, bundle.data
    b, prompt_len = batch["tokens"].shape[0], prompt_length(batch)
    max_len = prompt_len + gen_len
    cuda = track_peaks and device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    moved = 0 if tp is None else tp.stats["bytes"]
    prefill_cache, logits = bundle.prefill(params, batch)
    model_bytes = None if tp is None else {
        "prefill": tp.stats["bytes"] - moved}
    cache = make_cache(cfg, b, max_len, device=device, shards=tp, data=dp)
    restage(cache, prefill_cache, cfg, b, prompt_len, max_len, tp)
    del prefill_cache
    _sync(device)
    t_prefill = time.perf_counter() - t0
    peaks = {}
    if cuda:
        peaks["prefill"] = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)

    def pick(lg):
        lg = gather_from_model(lg, over(tp, lg.shape[-1], cfg.vocab_size))
        if temperature > 0:
            probs = torch.softmax(lg / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)
        else:
            tok = torch.argmax(lg, dim=-1, keepdim=True)
        if dp is not None and lg.shape[0] < b:
            tok = gather_dim(tok, dp, 0)
        return tok, lg

    tok, logits = pick(logits)
    toks, all_logits = [tok], [logits]
    t1 = time.perf_counter()
    decoded = 0
    for i in range(gen_len - 1):
        moved = 0 if tp is None else tp.stats["bytes"]
        cache, logits = bundle.decode_step(params, cache, tok, prompt_len + i,
                                           cache_len=max_len)
        if tp is not None:
            decoded += tp.stats["bytes"] - moved
        tok, logits = pick(logits)
        toks.append(tok)
        all_logits.append(logits)
    _sync(device)
    if model_bytes is not None:
        model_bytes["decode_step"] = decoded / max(gen_len - 1, 1)
    if cuda:
        peaks["decode"] = torch.cuda.max_memory_allocated(device)
    return Generation(torch.cat(toks, dim=1), torch.stack(all_logits, dim=1),
                      t_prefill, time.perf_counter() - t1, model_bytes,
                      peaks or None)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config's depth to this many layers")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-shards", type=int, default=1,
                    help="under torch.distributed.run: cut the weights and "
                         "caches over this many ranks (world = D x M)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; "
                         "raises without one)")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from repro_torch.launch.train import join_process_group

    if args.model_shards > 1 and not (dist.is_initialized()
                                      or "WORLD_SIZE" in os.environ):
        raise ValueError(
            f"--model-shards {args.model_shards} cuts the model over that "
            "many ranks: run under python -m torch.distributed.run with a "
            "world of D x model shards")
    owned, device = join_process_group(args.device)
    try:
        return _serve(args, device)
    finally:
        if owned:
            dist.destroy_process_group()


def _serve(args, device):
    import dataclasses
    import json

    import torch.distributed as dist

    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch.mesh import (
        coordinates,
        data_group,
        make_worker_mesh,
        model_group,
    )
    from repro_torch.models.parallel import DataShards, ModelShards

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if cfg.train_mode == "dp":
        # Pure DP is a training choice; serving takes the usec layout (the
        # reference's dry-run does the same).
        cfg = dataclasses.replace(cfg, train_mode="usec")
    if not cfg.decoder:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode path")
    shards = data = None
    rank, world = 0, 1
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        m_size = args.model_shards
        dev_type = "cuda" if device is None else torch.device(device).type
        mesh = make_worker_mesh(world // m_size, m_size, device_type=dev_type)
        d, m = coordinates(mesh)
        if m_size > 1:
            shards = ModelShards(model_group(mesh), m_size, m)
        if world // m_size > 1:
            data = DataShards(data_group(mesh), world // m_size, d)
    bundle = build_model(cfg, device=device, shards=shards, data=data)
    cuda = bundle.device.type == "cuda"
    if cuda:
        torch.zeros(1, device=bundle.device)
        torch.cuda.reset_peak_memory_stats(bundle.device)
    t0 = time.perf_counter()
    gen_dev = torch.Generator(device=bundle.device)
    params = bundle.init(gen_dev.manual_seed(args.seed))
    _sync(bundle.device)
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(bundle.device) if cuda \
        else None
    resting = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    batch = demo_batch(cfg, "prefill", args.batch, args.prompt_len,
                       seed=args.seed)
    launches = flash_attention_cuda.launches
    out = generate(bundle, params, batch, args.gen_len, args.temperature,
                   torch.Generator(device=bundle.device).manual_seed(
                       args.seed + 1), track_peaks=True)
    if not bool(torch.isfinite(out.logits).all()):
        raise AssertionError("non-finite logits during decode")
    gen = out.tokens.cpu().numpy()
    tps = args.batch * (args.gen_len - 1) / max(out.decode_s, 1e-9)
    report = {"prefill_s": out.prefill_s, "decode_s": out.decode_s,
              "decode_tokens_per_s": tps, "init_s": init_s,
              "param_bytes": resting,
              "init_peak_gb": None if init_peak is None else init_peak / 1e9,
              "peak_gb": (max(out.peak_bytes.values()) / 1e9
                          if cuda else None),
              "prefill_peak_bytes": (out.peak_bytes["prefill"] if cuda
                                     else None),
              "decode_peak_bytes": (out.peak_bytes["decode"] if cuda
                                    else None),
              "attention_kernel_launches":
                  flash_attention_cuda.launches - launches,
              "model_bytes": out.model_bytes,
              "tokens": gen.tolist()}
    reports = [report]
    if world > 1:
        reports = [None] * world
        dist.all_gather_object(reports, report)
    if rank == 0:
        print(f"prefill {args.batch}x{args.prompt_len} in "
              f"{out.prefill_s:.2f}s; decoded {args.gen_len - 1} steps in "
              f"{out.decode_s:.2f}s ({tps:.1f} tok/s) on {bundle.device}")
        print("sample token ids:", gen[0, :12].tolist())
        if world > 1:
            for r, rep in enumerate(reports):
                print(f"rank {r} of {world}: {json.dumps(rep)}", flush=True)
    return gen


if __name__ == "__main__":
    main()
