"""Model prefill + decode demo: the serving path of the model stack.

Twin of ``examples/decode_demo.py`` (which the reference's
``repro.launch.serve`` loads): build one of the ported architectures, draw
random weights from a seed, prefill a prompt batch from ``demo_batch``,
restage the prompt's cache into a full-length cache (KV leaves at the
start of the longer ones; the recurrent layers' fixed-shape conv and state
leaves whole), then run the greedy (or temperature) decode loop. On a GPU
every long-sequence attention of the prefill runs the hand-written flash
kernel. Not connected to the elastic engine.

Run (on a machine with an NVIDIA GPU; ``--device cpu`` runs the plain
PyTorch versions on the host):
  python -m repro_torch.launch.serve --arch glm4-9b --batch 1 \\
      --prompt-len 8192 --gen-len 32
  python -m repro_torch.launch.serve --arch recurrentgemma-2b --batch 1 \\
      --prompt-len 8192 --gen-len 32
  python -m repro_torch.launch.serve --arch mamba2-370m --batch 1 \\
      --prompt-len 8192 --gen-len 32
"""

from __future__ import annotations

import argparse
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
    logits: torch.Tensor   # (B, gen_len, vocab) fp32, the logits behind each
    prefill_s: float       # cache allocation + prefill + restage, synchronized
    decode_s: float        # the decode loop, synchronized


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(bundle, params, batch: Dict, gen_len: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> Generation:
    """Prefill ``batch["tokens"]`` (B, P), restage its cache into a
    ``make_cache(cfg, B, P + gen_len)`` cache, and decode ``gen_len - 1``
    more tokens: greedy at ``temperature == 0``, else sampled from
    ``softmax(logits / temperature)`` with ``generator``."""
    cfg, device = bundle.cfg, bundle.device
    b, prompt_len = batch["tokens"].shape
    t0 = time.perf_counter()
    cache = make_cache(cfg, b, prompt_len + gen_len, device=device)
    prefill_cache, logits = bundle.prefill(params, batch)
    # Place each prompt-length KV leaf at the start of the full-size one
    # (a recurrent layer's conv and state leaves have the same shape in
    # both and are copied whole).
    for full, pre in zip(tree_leaves(cache), tree_leaves(prefill_cache)):
        full[tuple(slice(0, s) for s in pre.shape)] = pre
    del prefill_cache
    _sync(device)
    t_prefill = time.perf_counter() - t0

    def pick(lg):
        if temperature > 0:
            probs = torch.softmax(lg / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)
        return torch.argmax(lg, dim=-1, keepdim=True)

    tok = pick(logits)
    toks, all_logits = [tok], [logits]
    t1 = time.perf_counter()
    for i in range(gen_len - 1):
        cache, logits = bundle.decode_step(params, cache, tok, prompt_len + i)
        tok = pick(logits)
        toks.append(tok)
        all_logits.append(logits)
    _sync(device)
    return Generation(torch.cat(toks, dim=1), torch.stack(all_logits, dim=1),
                      t_prefill, time.perf_counter() - t1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; "
                         "raises without one)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if not cfg.decoder:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode path")
    bundle = build_model(cfg, device=args.device)
    gen_dev = torch.Generator(device=bundle.device)
    params = bundle.init(gen_dev.manual_seed(args.seed))
    batch = demo_batch(cfg, "prefill", args.batch, args.prompt_len,
                       seed=args.seed)
    out = generate(bundle, params, batch, args.gen_len, args.temperature,
                   torch.Generator(device=bundle.device).manual_seed(
                       args.seed + 1))
    if not bool(torch.isfinite(out.logits).all()):
        raise AssertionError("non-finite logits during decode")
    gen = out.tokens.cpu().numpy()
    tps = args.batch * (args.gen_len - 1) / max(out.decode_s, 1e-9)
    print(f"prefill {args.batch}x{args.prompt_len} in {out.prefill_s:.2f}s; "
          f"decoded {args.gen_len - 1} steps in {out.decode_s:.2f}s "
          f"({tps:.1f} tok/s) on {bundle.device}")
    print("sample token ids:", gen[0, :12].tolist())
    return gen


if __name__ == "__main__":
    main()
