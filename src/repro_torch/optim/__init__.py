"""Optimizer substrate: AdamW + schedules. Twin of :mod:`repro.optim`."""

from . import adamw
from .schedule import constant, warmup_cosine

__all__ = ["adamw", "constant", "warmup_cosine"]
