"""Unannounced-failure injection and result integrity, NumPy only.

The port of :mod:`repro.faults`: a
:class:`~repro_torch.faults.chaos.ChaosPlan` of
:class:`~repro_torch.faults.chaos.FaultSpec`\\ s, consumed at the runner's
seams through a :class:`~repro_torch.faults.chaos.FaultInjector`, the
:class:`~repro_torch.faults.chaos.FaultAbort` signal the engine's recovery
loop catches, and the silent-corruption defense of
:mod:`repro_torch.faults.integrity` (Freivalds sketches, tile fingerprints,
worker health). Everything here runs on the host; the runner mirrors a
repaired tile onto the card in place.

Recovery invariant (held by ``tests/test_torch_faults.py`` and
``tests/test_torch_integrity.py`` against the JAX package): every output
row of a step is computed by exactly one surviving holder from identical
staged bits, so a run that recovers from any injected fault — masked as a
realized straggler, or demoted and re-executed — finishes bitwise-equal to
the clean run, with the executor cache still at one entry.
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
from .integrity import (
    SAMPLE_PERIOD,
    IntegrityChecker,
    WorkerHealth,
    censor_measurements,
    should_verify,
    tile_checksum,
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
    "IntegrityChecker",
    "SAMPLE_PERIOD",
    "WorkerHealth",
    "censor_measurements",
    "should_verify",
    "tile_checksum",
]
