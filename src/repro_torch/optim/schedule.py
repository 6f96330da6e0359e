"""LR schedules: fp32 scalar tensors of a step, as :mod:`repro.optim.schedule`."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine to
    ``final_frac · peak_lr`` at ``total_steps``; fp32, on the host."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    t = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5
                     * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, lr: float) -> torch.Tensor:
    return torch.tensor(lr, dtype=torch.float32)
