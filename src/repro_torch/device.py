"""Where the port's entry points run: CUDA unless the caller names a device."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. With no CUDA device and no explicit choice it raises; it never
    drifts onto the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on an NVIDIA GPU; pass "
            "device='cpu' to run its plain PyTorch versions on the host")
    return torch.device("cuda", torch.cuda.current_device())
