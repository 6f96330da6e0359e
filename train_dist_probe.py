#!/usr/bin/env python3
"""Training across ranks on the cards this machine has, without the rest
of the smoke run.

Run from the repository root on a CUDA machine:  python3 train_dist_probe.py

It builds the kernels, takes ``chip_smoke.py``'s ``train_path`` (3 steps of
internvl2-2b at full width and depth on one card through
``repro_torch.launch.train``) and then its ``train_dist``: with four or
more cards, 4 NCCL ranks of the same trainer at full depth under ``python
-m torch.distributed.run``, each step's loss and gradient norm held to
``train_path``'s; with fewer, 4 gloo ranks sharing one card at
``chip_smoke.DIST_DEPTH`` layers. One JSON line per phase, the card's name
and power limit first; exits non-zero if a check fails.
"""

import subprocess
import sys

import torch

import chip_smoke as cs


def main() -> int:
    if not torch.cuda.is_available():
        print("train_dist_probe: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.build_all()
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    _, metrics = cs.phase_train_path(
        dev, {"flash_attention": flash_attention_cuda}, smi)
    cs.phase_train_dist(dev, smi, metrics)
    return 0


if __name__ == "__main__":
    sys.exit(main())
