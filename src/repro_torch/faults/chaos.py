"""Deterministic chaos schedules and the fault-injection hook.

A NumPy copy of :mod:`repro.faults.chaos` (no torch, no JAX). The port's
runner consumes every kind at the same seams as the reference's.

Seven fault kinds, covering every unannounced-failure mode the engine
and serving layer recover from:

``worker_crash``
    The machine dies mid-step: its partial never arrives AND it leaves
    the fleet. Covered by the S budget → masked as a realized straggler
    for this step, then demoted (a synthesized preemption) before the
    next. Not covered → the dispatch aborts (:class:`FaultAbort`), the
    worker is demoted, a replan fires, and the step re-executes.
``result_drop``
    The dispatch completes but the partial never arrives (a network
    loss). Same detection and recovery as a crash — a silent worker is
    indistinguishable from a dead one until it reports again — except a
    *covered* drop does not demote: the worker stays in the fleet.
``speed_report_loss``
    The step's measured per-worker durations never reach the master:
    the EWMA update for that step is skipped. Pure telemetry loss — the
    step's output is already out, so the run stays bitwise-identical.
``stale_plan_table``
    The replicated plan state is invalidated (a lost broadcast): the
    runner's memoized plan cache — and, in decentral mode, the
    replicated :class:`~repro_torch.core.decentral.PlanTable` — is cleared.
    Recovery is a re-solve; plans are a pure function of (membership,
    speeds, S), so the recomputed plan arrays produce the same bits.
``scheduler_kill``
    The central Algorithm-1 master dies (subsumes the engine's legacy
    ``kill_scheduler_at``). Decentral mode survives on the replicated
    local rule; central mode raises
    :class:`~repro_torch.core.decentral.SchedulerKilledError` at the next
    planning decision.
``tile_corruption``
    Silent bit-rot in one worker's staged replica tile BEFORE the step
    dispatches. Unlike every kind above, nothing goes absent — the
    worker computes on garbage and answers on time. Detected by the
    staging-time tile fingerprints of
    :class:`~repro_torch.faults.integrity.IntegrityChecker` (when
    ``verify_results`` is on) and repaired by re-staging the tile from
    a surviving replica holder — the uncoded-redundancy recovery.
``result_corruption``
    One worker's returned partial is silently perturbed after compute.
    Detected by the seeded Freivalds sketch check; the partial is
    discarded (first-arrival: realized straggler; barrier: masked +
    re-dispatched; fused: rows recomputed from a replica tile), the
    step's timing is censored from the EWMA, and repeat offenders are
    graylisted.

The corruption kinds are deliberately NOT in :data:`GENERATE_KINDS`:
without ``verify_results`` enabled they make results silently wrong —
which is exactly the failure mode they exist to demonstrate — so a
:meth:`ChaosPlan.generate` schedule only draws them when asked.

Fault *steps* are the runner's executed-step indices (0-based): a spec
with ``step=3`` fires when the runner is about to execute its 4th step.
:meth:`ElasticEngine.run` installs the injector with ``base_step`` set
to the runner's current step count, so a plan's indices always mean
"steps of THIS run" regardless of what ran before.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ChaosPlan",
    "CORRUPTION_KINDS",
    "DISPATCH_KINDS",
    "FAULT_KINDS",
    "GENERATE_KINDS",
    "FaultAbort",
    "FaultInjector",
    "FaultRecord",
    "FaultSpec",
]

FAULT_KINDS: Tuple[str, ...] = (
    "worker_crash",
    "result_drop",
    "speed_report_loss",
    "stale_plan_table",
    "scheduler_kill",
    "tile_corruption",
    "result_corruption",
)

#: Kinds that target one worker's dispatch (``worker=`` required).
DISPATCH_KINDS: Tuple[str, ...] = ("worker_crash", "result_drop")

#: Kinds that hit the planning path, consulted before plan adoption.
PLANNING_KINDS: Tuple[str, ...] = ("scheduler_kill", "stale_plan_table")

#: Silent-corruption kinds (``worker=`` required): nothing goes absent,
#: the answer is just wrong. Only detectable with ``verify_results`` on.
CORRUPTION_KINDS: Tuple[str, ...] = ("tile_corruption", "result_corruption")

#: The default :meth:`ChaosPlan.generate` pool: the loss/telemetry kinds
#: whose recovery needs no integrity verification. Corruption kinds are
#: opt-in (pass ``kinds=``) — injecting them into a run that is not
#: verifying produces silently wrong results by design.
GENERATE_KINDS: Tuple[str, ...] = (
    "worker_crash",
    "result_drop",
    "speed_report_loss",
    "stale_plan_table",
    "scheduler_kill",
)


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: ``kind`` fires before step ``step`` executes
    (dispatch kinds name the ``worker`` whose result is lost)."""

    kind: str
    step: int
    worker: Optional[int] = None

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"kind must be one of {FAULT_KINDS}, got {self.kind!r}")
        if int(self.step) < 0:
            raise ValueError(f"step must be >= 0, got {self.step}")
        object.__setattr__(self, "step", int(self.step))
        if self.kind in DISPATCH_KINDS or self.kind in CORRUPTION_KINDS:
            if self.worker is None:
                raise ValueError(
                    f"{self.kind} targets one worker's dispatch; "
                    f"FaultSpec(kind={self.kind!r}, ...) needs worker=")
            object.__setattr__(self, "worker", int(self.worker))
        elif self.worker is not None:
            raise ValueError(
                f"{self.kind} is not worker-addressed; drop worker=")


class ChaosPlan:
    """An ordered, validated schedule of :class:`FaultSpec`\\ s.

    Immutable once built; :meth:`generate` draws a deterministic seeded
    schedule (same seed → same faults, bit for bit), which is what the
    nightly chaos sweep enumerates.
    """

    def __init__(self, faults: Iterable[FaultSpec] = ()):
        specs = tuple(faults)
        for f in specs:
            if not isinstance(f, FaultSpec):
                raise TypeError(f"ChaosPlan wants FaultSpecs, got {f!r}")
        seen = set()
        for f in specs:
            key = (f.step, f.worker, f.kind)
            if key in seen:
                raise ValueError(
                    f"duplicate fault spec (step={f.step}, "
                    f"worker={f.worker}, kind={f.kind!r}): each "
                    f"(step, worker, kind) may appear at most once")
            seen.add(key)
        self.faults: Tuple[FaultSpec, ...] = tuple(sorted(
            specs, key=lambda f: (f.step, f.kind, -1 if f.worker is None
                                  else f.worker)))

    def __len__(self) -> int:
        return len(self.faults)

    def __iter__(self) -> Iterator[FaultSpec]:
        return iter(self.faults)

    def __repr__(self) -> str:
        return f"ChaosPlan({list(self.faults)!r})"

    @property
    def max_step(self) -> int:
        return max((f.step for f in self.faults), default=-1)

    def faults_at(self, step: int) -> Tuple[FaultSpec, ...]:
        return tuple(f for f in self.faults if f.step == int(step))

    @classmethod
    def generate(
        cls,
        n_steps: int,
        n_machines: int,
        n_faults: int = 3,
        kinds: Sequence[str] = GENERATE_KINDS,
        seed: int = 0,
    ) -> "ChaosPlan":
        """Draw a deterministic schedule: ``n_faults`` faults at distinct
        steps of ``[0, n_steps)``, kinds cycled from ``kinds`` in drawn
        order, worker-addressed kinds targeting a uniformly drawn
        worker. Defaults to :data:`GENERATE_KINDS`; pass corruption
        kinds explicitly to draw them."""
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        if n_machines < 1:
            raise ValueError(f"n_machines must be >= 1, got {n_machines}")
        for k in kinds:
            if k not in FAULT_KINDS:
                raise ValueError(
                    f"kinds must be drawn from {FAULT_KINDS}, got {k!r}")
        n_faults = min(int(n_faults), int(n_steps))
        rng = np.random.default_rng(seed)
        steps = sorted(rng.choice(n_steps, size=n_faults, replace=False))
        order = rng.permutation(len(kinds))
        specs = []
        for i, step in enumerate(steps):
            kind = kinds[int(order[i % len(order)])]
            addressed = kind in DISPATCH_KINDS or kind in CORRUPTION_KINDS
            worker = int(rng.integers(n_machines)) if addressed else None
            specs.append(FaultSpec(kind=kind, step=int(step), worker=worker))
        return cls(specs)


@dataclass
class FaultRecord:
    """What one fired fault translated to — the recovery log entry.

    action: ``"masked"`` (covered by the S budget: realized straggler),
    ``"demoted"`` (budget exceeded: abort → preempt → replan →
    re-execute), ``"killed"`` (scheduler tombstoned),
    ``"invalidated"`` (plan state cleared), ``"report_dropped"`` (EWMA
    update skipped), or ``"noop"`` (the target was not in play).
    ``detect_s`` is the modeled detection latency (the dispatch
    timeout); ``recover_s`` is the measured host time from abort to the
    completed re-executed step (filled by the engine's recovery loop).
    """

    spec: FaultSpec
    action: str
    detail: str = ""
    detect_s: float = 0.0
    recover_s: float = 0.0


class FaultAbort(RuntimeError):
    """A dispatch could not proceed: the fault ate the straggler budget.

    Raised by the runner BEFORE any state-mutating dispatch, so the
    caller's operand/carry is still valid. Carries what the recovery
    loop needs: the step index, the workers whose results are lost, and
    the subset to demote (treat as preempted) before re-executing.
    """

    def __init__(self, step: int, kind: str, lost: Sequence[int],
                 demote: Sequence[int], detail: str = ""):
        self.step = int(step)
        self.kind = str(kind)
        self.lost = tuple(sorted(int(n) for n in lost))
        self.demote = tuple(sorted(int(n) for n in demote))
        msg = (f"step {self.step}: {self.kind} lost worker(s) "
               f"{list(self.lost)} beyond the straggler budget; "
               f"demote {list(self.demote)} and re-execute")
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


class FaultInjector:
    """Consumes a :class:`ChaosPlan` at the runner's seams, one-shot.

    The runner queries it at each step's head; a fired fault is consumed
    immediately so a recovery retry of the same step does not re-fire
    it. Everything fired lands in :attr:`log` as a :class:`FaultRecord`
    — the recovery trace tests and benches audit.

    ``base_step`` shifts the plan's step indices: the engine installs
    the injector with the runner's current step count, so plan indices
    count steps of the run being launched.
    """

    def __init__(self, plan: Optional[ChaosPlan] = None,
                 base_step: int = 0,
                 detect_latency: float = 0.0):
        plan = plan if plan is not None else ChaosPlan()
        self.base_step = int(base_step)
        self.detect_latency = float(detect_latency)
        self._pending: Dict[int, List[FaultSpec]] = {}
        for f in plan:
            self._pending.setdefault(f.step + self.base_step, []).append(f)
        self.log: List[FaultRecord] = []

    @classmethod
    def coerce(cls, obj, base_step: int = 0) -> Optional["FaultInjector"]:
        """Accept a ChaosPlan, a FaultSpec iterable, an already-built
        injector (used as-is: its indices are absolute), or None."""
        if obj is None:
            return None
        if isinstance(obj, FaultInjector):
            return obj
        if isinstance(obj, ChaosPlan):
            return cls(obj, base_step=base_step)
        return cls(ChaosPlan(obj), base_step=base_step)

    # ------------------------------------------------------------------ #
    def add(self, spec: FaultSpec, absolute: bool = False) -> None:
        """Schedule one more fault (``absolute=False`` applies
        ``base_step``, matching construction-time indices)."""
        at = spec.step + (0 if absolute else self.base_step)
        self._pending.setdefault(at, []).append(spec)

    def has_fault(self, step: int, kinds: Optional[Sequence[str]] = None
                  ) -> bool:
        """Peek: does any (matching) fault wait at absolute ``step``?"""
        specs = self._pending.get(int(step), ())
        if kinds is None:
            return bool(specs)
        return any(f.kind in kinds for f in specs)

    def take(self, step: int, kinds: Optional[Sequence[str]] = None
             ) -> List[FaultSpec]:
        """Consume (one-shot) the faults waiting at absolute ``step``
        whose kind is in ``kinds`` (None = all)."""
        specs = self._pending.get(int(step))
        if not specs:
            return []
        if kinds is None:
            taken, kept = list(specs), []
        else:
            taken = [f for f in specs if f.kind in kinds]
            kept = [f for f in specs if f.kind not in kinds]
        if kept:
            self._pending[int(step)] = kept
        else:
            self._pending.pop(int(step), None)
        return taken

    def record(self, spec: FaultSpec, action: str, detail: str = "",
               detect_s: Optional[float] = None) -> FaultRecord:
        rec = FaultRecord(
            spec=spec, action=action, detail=detail,
            detect_s=self.detect_latency if detect_s is None else detect_s,
        )
        self.log.append(rec)
        return rec

    # ------------------------------------------------------------------ #
    @property
    def pending(self) -> int:
        return sum(len(v) for v in self._pending.values())

    def fired(self, action: Optional[str] = None) -> int:
        if action is None:
            return len(self.log)
        return sum(1 for r in self.log if r.action == action)
