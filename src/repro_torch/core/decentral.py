"""Decentralized re-planning: every worker IS the scheduler.

The central :class:`~repro_torch.core.scheduler.USECScheduler` is a single point
of failure and a serialization point for churn — the per-iteration
coordination cost the decentralized-USEC line (arXiv:2403.00585) argues
storage design should eliminate. This module removes the master from the
live path by turning Algorithm 1's re-planning decision into a **pure,
deterministic local rule** any worker can evaluate from replicated state
alone:

    local_replan(membership_bitmask, placement, speed_table, S) -> StepPlan

Determinism is the whole design: the LP solver, the Dinkelbach c*
iteration, the filling peel and the integerizer are all deterministic pure
functions, so N workers holding the same (placement, speed-table snapshot,
S) compile **bitwise-identical** plans from the same membership bitmask —
no election, no coordination round, no plan exchange. The rule reuses the
central pipeline verbatim (``solve_assignment`` with the master's
lexicographic settings + ``compile_plan_batch``, the batched compiler
already proven bit-equal to scalar ``compile_plan``), so agreement with
the central solver is a theorem about purity, checked bit-for-bit by the
differential suite in ``tests/test_decentral.py``.

Replicated state has two parts:

- :class:`SpeedSnapshot` — the EWMA speed table plus a **version** counter
  bumped on every measurement broadcast. The live runner only ingests
  measurements at step/window boundaries, so a version is exactly "the
  estimator state all workers share between broadcasts".
- :class:`PlanTable` — plans keyed by membership bitmask, each entry
  stamped with the (version, S, t_max) it was evaluated under. While the
  stamp matches, re-evaluating the pure rule would reproduce the entry's
  bits, so the live path is a **table lookup**: churn costs a dict probe,
  not a solve. The runner's speculative neighbor precompile
  (:meth:`DecentralPlanner.plan_batch`) fills the table ahead of churn, so
  steady-state replans do ZERO on-demand solves (asserted by the bench
  smoke).

:class:`DecentralPlanner` packages the rule + table + snapshot as a
drop-in :class:`USECScheduler` replacement (one worker's replica of the
decision procedure); :class:`DeadScheduler` / :class:`SchedulerKilledError`
are the fault-injection half — the engine can kill the central master
mid-run and a ``replan="decentral"`` runner carries the job to completion
bitwise-identical to the uninterrupted central run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from .assignment import solve_assignment
from .placement import Placement
from .plan import compile_plan_batch
from .scheduler import StepPlan, USECScheduler, derive_t_max

__all__ = [
    "DeadScheduler",
    "DecentralPlanner",
    "PlanTable",
    "SchedulerKilledError",
    "SpeedSnapshot",
    "bitmask_members",
    "local_replan",
    "local_replan_batch",
    "membership_bitmask",
]


# ---------------------------------------------------------------------- #
# Membership bitmasks: the shared-state key every worker derives locally
# ---------------------------------------------------------------------- #
def membership_bitmask(available: Iterable[int], n_machines: int) -> int:
    """Pack an availability set into the canonical bitmask key (bit n set
    iff machine n is available). Order- and duplicate-insensitive, so every
    worker observing the same membership derives the same key."""
    mask = 0
    for a in available:
        n = int(a)
        if not 0 <= n < n_machines:
            raise ValueError(
                f"machine id {n} out of range: ids are 0..{n_machines - 1}")
        mask |= 1 << n
    return mask


def bitmask_members(mask: int, n_machines: int) -> Tuple[int, ...]:
    """Unpack a membership bitmask into the sorted availability tuple (the
    scheduler's canonical ``avail_t`` form)."""
    mask = int(mask)
    if mask < 0 or mask >> n_machines:
        raise ValueError(
            f"bitmask {mask:#x} has bits outside 0..{n_machines - 1}")
    return tuple(n for n in range(n_machines) if mask >> n & 1)


# ---------------------------------------------------------------------- #
# The pure local rule
# ---------------------------------------------------------------------- #
def local_replan_batch(
    masks: Sequence[int],
    placement: Placement,
    speed_table: Sequence[float],
    stragglers: int = 0,
    *,
    rows_per_tile: int,
    row_align: int = 1,
    t_max: Optional[int] = None,
    homogeneous: bool = False,
) -> Tuple[StepPlan, ...]:
    """Evaluate the local rule for a *stack* of membership bitmasks.

    Pure and deterministic: no state is read beyond the arguments, none is
    written. Solver settings are exactly the central master's fresh-solve
    path (lexicographic leveling, same S), and every plan compiles through
    ONE :func:`~repro_torch.core.plan.compile_plan_batch` call — the peel /
    integerize / c* pipeline is reused, not reimplemented, so each result
    is bit-for-bit what ``USECScheduler.plan_step`` would produce at the
    same (speed table, S). ``t_max=None`` derives the master's own static
    capacity (:func:`~repro_torch.core.scheduler.derive_t_max`), keeping the
    padded array shapes — and hence bitwise identity — aligned.
    """
    S = int(stragglers)
    speed_table = np.asarray(speed_table, dtype=np.float64)
    s_plan = np.ones_like(speed_table) if homogeneous else speed_table
    if t_max is None:
        t_max = derive_t_max(placement, S)
    avail_ts = [bitmask_members(m, placement.n_machines) for m in masks]
    sols = [
        solve_assignment(placement, s_plan, available=av, stragglers=S)
        for av in avail_ts
    ]
    plans = compile_plan_batch(
        placement, sols,
        rows_per_tile=int(rows_per_tile),
        stragglers=S,
        speeds=s_plan,
        row_align=int(row_align),
        t_max=int(t_max),
    )
    return tuple(
        StepPlan(step=0, available=av, speeds=speed_table.copy(),
                 solution=sol, plan=plan)
        for av, sol, plan in zip(avail_ts, sols, plans)
    )


def local_replan(
    membership_bitmask: int,
    placement: Placement,
    speed_table: Sequence[float],
    stragglers: int = 0,
    *,
    rows_per_tile: int,
    row_align: int = 1,
    t_max: Optional[int] = None,
    homogeneous: bool = False,
) -> StepPlan:
    """The decentralized re-planning rule for ONE membership bitmask —
    the one-mask view of :func:`local_replan_batch` (a stack of size 1, so
    the two can never diverge). Any worker holding the shared
    (placement, speed table, S) evaluates this independently and lands on
    the same plan bits as every peer — and as the central solver."""
    return local_replan_batch(
        [membership_bitmask], placement, speed_table, stragglers,
        rows_per_tile=rows_per_tile, row_align=row_align, t_max=t_max,
        homogeneous=homogeneous,
    )[0]


# ---------------------------------------------------------------------- #
# Replicated state: versioned speed snapshots + the plan table
# ---------------------------------------------------------------------- #
@dataclass(frozen=True)
class SpeedSnapshot:
    """One broadcast of the shared speed table. ``version`` increments on
    every measurement ingest (= every window-boundary broadcast in the
    runner), so two workers comparing versions know whether their tables
    are byte-identical without comparing the arrays."""

    version: int
    speeds: np.ndarray


@dataclass
class _TableEntry:
    step_plan: StepPlan
    version: int      # speed-table version the rule was evaluated under
    stragglers: int   # ... and the tolerance S
    t_max: int        # ... and the padded segment capacity


class PlanTable:
    """Replicated plan table: membership bitmask -> evaluated rule output.

    An entry is served only while its (version, S, t_max) stamp matches the
    caller's current shared state — under a matching stamp the pure rule
    would reproduce the entry bit-for-bit, so the lookup IS the replan.
    Any stamp mismatch (a speed broadcast landed, S was re-committed, the
    capacity was re-derived) silently invalidates: the entry stays until
    overwritten, but is never served stale.
    """

    def __init__(self):
        self._entries: Dict[int, _TableEntry] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, mask: int) -> bool:
        return int(mask) in self._entries

    def lookup(self, mask: int, version: int, stragglers: int,
               t_max: int) -> Optional[StepPlan]:
        e = self._entries.get(int(mask))
        if e is None:
            return None
        if (e.version != int(version) or e.stragglers != int(stragglers)
                or e.t_max != int(t_max)):
            return None
        return e.step_plan

    def insert(self, mask: int, step_plan: StepPlan, version: int,
               stragglers: int, t_max: int) -> None:
        self._entries[int(mask)] = _TableEntry(
            step_plan=step_plan, version=int(version),
            stragglers=int(stragglers), t_max=int(t_max))

    def clear(self) -> None:
        self._entries.clear()


# ---------------------------------------------------------------------- #
# A worker's replica of the Algorithm-1 decision procedure
# ---------------------------------------------------------------------- #
class DecentralPlanner(USECScheduler):
    """Drop-in scheduler whose live path is the decentralized rule.

    Same constructor, same interface, same *bits* as the central master —
    but every plan is produced by :func:`local_replan_batch` over replicated
    state instead of a privileged master's private loop, and repeated
    memberships under an unchanged speed snapshot are served from the
    :class:`PlanTable` without solving anything. The EWMA estimator is the
    replicated speed table; :meth:`report` is a broadcast (version bump).

    Counters: ``table_hits`` (plans served by pure lookup),
    ``on_demand_solves`` (rule evaluations forced on the live path —
    zero in the steady state when the neighbor precompile keeps the table
    warm; ``plan_batch`` evaluations are speculative, not on-demand).

    The waste-averse branch (``waste_epsilon > 0``) is inherently
    history-dependent (it may reuse the *previous* plan), so it cannot be
    a pure function of (mask, snapshot): with it enabled the planner
    delegates to the central branch verbatim and bypasses the table —
    decisions remain bitwise-identical to the central master, only the
    lookup shortcut is forfeited.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.table = PlanTable()
        self._version = 0
        self.table_hits = 0
        self.on_demand_solves = 0

    # -- replicated state ------------------------------------------------ #
    @property
    def speed_table_version(self) -> int:
        """Broadcast counter of the shared speed table."""
        return self._version

    def snapshot(self) -> SpeedSnapshot:
        """The (version, speeds) pair a worker would gossip to peers."""
        return SpeedSnapshot(self._version, self.estimator.speeds)

    def report(self, loads, durations) -> None:
        """Measurement ingest = broadcast: the shared table changed, so
        every stamped plan is invalidated by the version bump."""
        super().report(loads, durations)
        self._version += 1

    # -- the live path --------------------------------------------------- #
    def _rule(self, masks: Sequence[int]) -> Tuple[StepPlan, ...]:
        """Evaluate the pure rule under this replica's current snapshot."""
        return local_replan_batch(
            masks, self.placement, self.estimator.speeds, self.stragglers,
            rows_per_tile=self.rows_per_tile, row_align=self.row_align,
            t_max=self.t_max, homogeneous=self.homogeneous,
        )

    def plan_step(self, available, measured=None) -> StepPlan:
        if measured:
            self.estimator.update(measured)
            self._version += 1
        if self.waste_epsilon > 0:
            # History-dependent branch: central semantics, no table.
            return super().plan_step(available, measured=None)
        mask = membership_bitmask(available, self.placement.n_machines)
        cached = self.table.lookup(
            mask, self._version, self.stragglers, self.t_max)
        if cached is not None:
            self.table_hits += 1
            self._step += 1
            out = StepPlan(
                step=self._step, available=cached.available,
                speeds=self.estimator.speeds, solution=cached.solution,
                plan=cached.plan,
            )
            self._prev = out
            return out
        self.on_demand_solves += 1
        splan = self._rule([mask])[0]
        self.table.insert(mask, splan, self._version, self.stragglers,
                          self.t_max)
        self._step += 1
        out = StepPlan(
            step=self._step, available=splan.available, speeds=splan.speeds,
            solution=splan.solution, plan=splan.plan,
        )
        self._prev = out
        return out

    def plan_batch(self, memberships) -> Tuple[StepPlan, ...]:
        """Speculative membership-stack planning through the local rule.

        Bitwise-identical to the central ``plan_batch`` (same solves, same
        batched compile); additionally every result is inserted into the
        replicated table under the current snapshot — this is how the
        runner's neighbor precompile warms the table so churn lands on a
        lookup, not a solve."""
        masks = [
            membership_bitmask(m, self.placement.n_machines)
            for m in memberships
        ]
        splans = self._rule(masks)
        out = tuple(
            StepPlan(step=self._step, available=sp.available,
                     speeds=sp.speeds, solution=sp.solution, plan=sp.plan)
            for sp in splans
        )
        if self.waste_epsilon == 0:
            for mask, sp in zip(masks, out):
                self.table.insert(mask, sp, self._version, self.stragglers,
                                  self.t_max)
        return out


# ---------------------------------------------------------------------- #
# Scheduler fault injection
# ---------------------------------------------------------------------- #
class SchedulerKilledError(RuntimeError):
    """The central scheduler was killed and something touched it."""


class DeadScheduler:
    """Tombstone left where a killed scheduler used to be. Every attribute
    access raises :class:`SchedulerKilledError` — a run that still depends
    on the central master fails loudly at its next planning decision,
    while a ``replan="decentral"`` run never touches it again."""

    def __init__(self, reason: str = "fault injection"):
        self.reason = reason

    def __repr__(self) -> str:  # repr must not raise (debuggers, logs)
        return f"DeadScheduler(reason={self.reason!r})"

    def __getattr__(self, name: str):
        raise SchedulerKilledError(
            f"the central scheduler was killed ({self.reason}) and "
            f"{name!r} was accessed — the master is gone. Run with "
            f"Policy(replan='decentral') to survive scheduler failure: "
            f"every worker then re-plans from the replicated "
            f"(membership bitmask, speed table, plan table) state."
        )
