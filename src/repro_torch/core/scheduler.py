"""The adaptive USEC scheduler — paper Algorithm 1, master side.

Per time step:

  1. update the EWMA speed estimate from last step's worker reports,
  2. read the current available set N_t from the elasticity trace,
  3. solve the assignment LP (eq. (8)) for the restricted placement,
  4. run the filling algorithm and compile the padded plan,
  5. hand the plan (plain arrays) to the execution runtime.

The scheduler is pure host-side numpy; jitted executors consume its plans as
inputs, so membership/speed changes never recompile. The live execution loop
around it (trace -> measured durations -> plan -> devices) is
:class:`repro_torch.runtime.elastic_runner.ElasticRunner`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .assignment import AssignmentSolution, solve_assignment
from .elastic import AvailabilityTrace
from .placement import Placement
from .plan import CompiledPlan, compile_plan, compile_plan_batch
from .speed import SpeedEstimator


def derive_t_max(placement: Placement, stragglers: int) -> int:
    """Static per-worker segment capacity for a (placement, S) pair: bound
    segments/worker so plans keep one shape across the whole run. Per tile
    a worker holds, the filling algorithm emits <= N_g segments of which
    the worker joins a few; a safe, tight-enough bound is (tiles stored) *
    (2+S) — the extra slot absorbs integerization splits at tile
    boundaries. Shared by the central master and the decentralized local
    rule (:func:`repro_torch.core.decentral.local_replan`): both must pad plans
    to the SAME capacity or bitwise plan identity is lost."""
    z = placement.storage_sets()
    return max(len(zn) for zn in z) * (1 + int(stragglers) + 1)


@dataclass
class StepPlan:
    """Everything the runtime needs for one elastic step."""

    step: int
    available: Tuple[int, ...]
    speeds: np.ndarray
    solution: AssignmentSolution
    plan: CompiledPlan

    @property
    def c_star(self) -> float:
        return self.solution.c_star


class USECScheduler:
    """Master-side adaptive scheduler (Algorithm 1)."""

    def __init__(
        self,
        placement: Placement,
        rows_per_tile: int,
        initial_speeds: Sequence[float],
        stragglers: int = 0,
        gamma: float = 0.5,
        row_align: int = 1,
        t_max: Optional[int] = None,
        homogeneous: bool = False,
        waste_epsilon: float = 0.0,
    ):
        """``waste_epsilon > 0`` enables transition-waste-averse re-planning
        (the metric of [Dau et al., ISIT'20], which the paper cites as [2]):
        while membership is unchanged and the PREVIOUS assignment is still
        within ``(1 + eps)`` of the fresh optimum under the drifted speed
        estimates, the previous plan is reused verbatim — zero rows move.
        A fresh plan is computed only on membership change or when drift
        makes the old plan more than ``eps`` suboptimal."""
        self.placement = placement
        self.rows_per_tile = int(rows_per_tile)
        self.stragglers = int(stragglers)
        self.row_align = int(row_align)
        self.estimator = SpeedEstimator(initial_speeds, gamma=gamma)
        self.homogeneous = bool(homogeneous)
        self.waste_epsilon = float(waste_epsilon)
        self._prev: Optional[StepPlan] = None
        self._step = 0
        self._t_max_explicit = t_max is not None
        self.t_max = self._derive_t_max() if t_max is None else t_max

    def _derive_t_max(self) -> int:
        """See :func:`derive_t_max` (module-level so the decentralized
        local rule pads to the identical capacity)."""
        return derive_t_max(self.placement, self.stragglers)

    @property
    def speeds(self) -> np.ndarray:
        """Current EWMA speed estimates (copy) — what the next plan will see."""
        return self.estimator.speeds

    @property
    def plan_speeds(self) -> np.ndarray:
        """The speeds the next solve will actually plan under (copy):
        the EWMA estimates, or all-ones in ``homogeneous`` baseline mode."""
        s_hat = self.estimator.speeds
        return np.ones_like(s_hat) if self.homogeneous else s_hat

    def probe_c_star(self, available: Sequence[int]) -> float:
        """Fresh optimum c* for ``available`` under the current plan speeds
        (one cheap non-lexicographic solve; no scheduler state is touched).
        The runner's speed-drift gate compares a memoized plan against this
        before paying for a full re-plan."""
        return solve_assignment(
            self.placement, self.plan_speeds, available=available,
            stragglers=self.stragglers, lexicographic=False,
        ).c_star

    def plan_batch(self, memberships: Sequence[Sequence[int]]) -> Tuple[StepPlan, ...]:
        """Plan a *stack* of membership states under the current estimates.

        Solves each membership's LP (same settings as :meth:`plan_step`'s
        fresh-solve path) and compiles every plan in ONE
        :func:`~repro_torch.core.plan.compile_plan_batch` call — the batched
        membership-space compiler. Unlike :meth:`plan_step` this touches no
        scheduler state (no estimator update, no waste-averse previous
        plan), so the runner can speculatively pre-compile the churn
        neighborhood of the current membership without perturbing the
        Algorithm-1 loop. Each returned plan is bitwise-identical to what
        ``plan_step`` would compile for that membership at this estimator
        state."""
        s_hat = self.estimator.speeds
        s_plan = self.plan_speeds
        avail_ts = [
            tuple(sorted(int(a) for a in av)) for av in memberships
        ]
        sols = [
            solve_assignment(
                self.placement, s_plan, available=av,
                stragglers=self.stragglers,
            )
            for av in avail_ts
        ]
        plans = compile_plan_batch(
            self.placement, sols,
            rows_per_tile=self.rows_per_tile,
            stragglers=self.stragglers,
            speeds=s_plan,
            row_align=self.row_align,
            t_max=self.t_max,
        )
        return tuple(
            StepPlan(step=self._step, available=av, speeds=s_hat,
                     solution=sol, plan=plan)
            for av, sol, plan in zip(avail_ts, sols, plans)
        )

    def plan_step(
        self,
        available: Sequence[int],
        measured: Optional[Dict[int, float]] = None,
    ) -> StepPlan:
        """Lines 3–7 of Algorithm 1: update speeds, re-plan for N_t."""
        if measured:
            self.estimator.update(measured)
        s_hat = self.estimator.speeds
        if self.homogeneous:
            # Baseline mode: ignore measured heterogeneity (the comparison
            # point in the paper's Fig. 4): plan as if all speeds are equal.
            s_plan = np.ones_like(s_hat)
        else:
            s_plan = s_hat

        avail_t = tuple(sorted(int(a) for a in available))
        if (
            self.waste_epsilon > 0
            and self._prev is not None
            and self._prev.available == avail_t
        ):
            # Waste-averse path: ONE cheap single-round solve (c* is exact
            # with or without leveling) both checks near-optimality of the
            # old plan and, on drift past eps, IS the adopted solution —
            # the old code solved again lexicographically and discarded
            # this one. Skipping the leveling on the adopt path is
            # deliberate: balancing loads below the max moves rows for
            # zero c* gain, the opposite of what waste aversion wants.
            solution = solve_assignment(
                self.placement, s_plan, available=available,
                stragglers=self.stragglers, lexicographic=False,
            )
            old_c = self._prev.solution.time_of(s_plan)
            if old_c <= (1.0 + self.waste_epsilon) * solution.c_star + 1e-12:
                self._step += 1
                reused = StepPlan(
                    step=self._step, available=avail_t, speeds=s_hat,
                    solution=self._prev.solution, plan=self._prev.plan,
                )
                self._prev = reused
                return reused
        else:
            solution = solve_assignment(
                self.placement, s_plan, available=available,
                stragglers=self.stragglers,
            )
        plan = compile_plan(
            self.placement,
            solution,
            rows_per_tile=self.rows_per_tile,
            stragglers=self.stragglers,
            speeds=s_plan,
            row_align=self.row_align,
            t_max=self.t_max,
        )
        self._step += 1
        out = StepPlan(
            step=self._step,
            available=avail_t,
            speeds=s_hat,
            solution=solution,
            plan=plan,
        )
        self._prev = out
        return out

    def report(self, loads: Dict[int, float], durations: Dict[int, float]) -> None:
        """Lines 14–15: ingest worker speed measurements for the next step."""
        self.estimator.update(self.estimator.measure(loads, durations))

    def select_straggler_tolerance(
        self,
        available: Sequence[int],
        candidates: Sequence[int] = (0, 1, 2),
        n_draws: int = 256,
        expected_stragglers: int = 1,
        straggle_mode: str = "uniform",
        jitter_sigma: float = 0.3,
        quantile: float = 0.95,
        seed: int = 0,
        commit: bool = False,
        completion: str = "coverage",
    ) -> Tuple[int, Dict[int, float]]:
        """Batched lookahead: pick S from simulated completion distributions.

        For each candidate S, plans under the current speed estimates and
        scores the plan on ``n_draws`` simulated scenarios — realized speeds
        jittered lognormally around the estimates, plus
        ``expected_stragglers`` drawn per scenario by ``straggle_mode``
        (the environment model). The score is the ``quantile`` of the
        completion-time distribution, with infeasible draws (a plan that
        cannot survive the drawn straggler set) counting as +inf — so a
        tolerance below the expected straggler rate is never selected.
        ``completion`` selects :func:`simulate_batch`'s consume model, so
        the lookahead prices S under the semantics the runner will actually
        execute — ``"order"`` for an ``arrival="first"`` runner (the
        (N−S)-th order statistic), ``"barrier"`` for the bulk-synchronous
        step, ``"coverage"`` for the legacy idealized per-segment master.

        Returns ``(best_S, {S: score})``; candidates the placement cannot
        support (replication < 1+S) are omitted from the scores. With
        ``commit=True`` the chosen S becomes this scheduler's tolerance for
        subsequent :meth:`plan_step` calls (re-deriving the static t_max
        capacity bound).
        """
        from repro_torch.runtime.scenarios import draw_scenarios
        from repro_torch.runtime.simulate import simulate_batch

        avail_t = tuple(sorted(int(a) for a in available))
        restricted = self.placement.restrict(avail_t)
        s_hat = self.estimator.speeds
        rng = np.random.default_rng(seed)
        # ONE shared scenario batch for every candidate (common random
        # numbers): candidates are compared on identical draws, so scores
        # differ only by plan quality, never by draw-set noise, and a
        # candidate's score does not depend on which others are scored.
        realized, drop = draw_scenarios(
            s_hat, n_draws, jitter_sigma, rng, avail_t,
            n_stragglers=expected_stragglers,
            straggler_mode=straggle_mode)
        scores: Dict[int, float] = {}
        for S in candidates:
            if restricted.replication < 1 + int(S):
                continue
            solution = solve_assignment(
                self.placement, s_hat, available=avail_t,
                stragglers=int(S), lexicographic=False,
            )
            plan = compile_plan(
                self.placement, solution,
                rows_per_tile=self.rows_per_tile, stragglers=int(S),
                speeds=s_hat, row_align=self.row_align,
            )
            timing = simulate_batch(plan, realized, dropped=drop,
                                    on_infeasible="inf",
                                    completion=completion)
            # Order statistic, not interpolation: +inf draws must surface
            # as +inf scores (interpolating between infs yields NaN).
            scores[int(S)] = float(np.quantile(
                timing.completion_times, quantile, method="lower"))
        if not scores:
            raise ValueError(
                f"no feasible straggler tolerance among {tuple(candidates)} "
                f"for availability {avail_t}"
            )
        best = min(scores, key=lambda s: (scores[s], s))
        if commit and best != self.stragglers:
            self.stragglers = best
            if not self._t_max_explicit:
                # A user-pinned t_max stays (one static shape for the whole
                # run is exactly what an explicit cap is for).
                self.t_max = self._derive_t_max()
            self._prev = None  # old plan has a different tolerance
        return best, scores
