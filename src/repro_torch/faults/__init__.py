"""Unannounced-failure injection (the chaos subsystem), NumPy only.

The port of :mod:`repro.faults`' schedule and hook: a
:class:`~repro_torch.faults.chaos.ChaosPlan` of
:class:`~repro_torch.faults.chaos.FaultSpec`\\ s, consumed at the runner's
seams through a :class:`~repro_torch.faults.chaos.FaultInjector`, and the
:class:`~repro_torch.faults.chaos.FaultAbort` signal. The runner consumes
the planning kinds (``scheduler_kill``, ``stale_plan_table``); the dispatch
and corruption kinds, and the integrity checker, are ROADMAP.md Queue 1
item 8.
"""

from .chaos import (
    CORRUPTION_KINDS,
    DISPATCH_KINDS,
    FAULT_KINDS,
    GENERATE_KINDS,
    PLANNING_KINDS,
    ChaosPlan,
    FaultAbort,
    FaultInjector,
    FaultRecord,
    FaultSpec,
)

__all__ = [
    "ChaosPlan",
    "CORRUPTION_KINDS",
    "DISPATCH_KINDS",
    "FAULT_KINDS",
    "GENERATE_KINDS",
    "PLANNING_KINDS",
    "FaultAbort",
    "FaultInjector",
    "FaultRecord",
    "FaultSpec",
]
