"""ElasticEngine: one front door over the simulate and device stacks.

The port of :mod:`repro.api.engine`. The same run — a workload, a
:class:`~repro_torch.api.policy.Policy`, an :class:`EngineConfig`, an
availability trace, a straggler policy — executes either way by flipping one
argument:

- ``backend="simulate"``: the analytical path. Plans are solved per
  membership state (memoized), stacked, and every (step, draw) scenario is
  evaluated in ONE :func:`repro_torch.runtime.simulate.simulate_batch` pass,
  bitwise the JAX package's simulate backend.
- ``backend="device"``: the live path on the card. The
  :class:`~repro_torch.runtime.elastic_runner.ElasticRunner` executes every
  step through the hand-written kernels (``usec_matvec`` per block, or one
  ``usec_segmented`` launch a step with ``segmented=``); churn swaps plan
  arrays, the executor is built once, and per-step results verify against a
  float64 host reference. ``device=None`` means CUDA; with no CUDA device
  the engine raises unless the caller passes ``device="cpu"``.

Not ported yet: fault injection (``faults=``, ``kill_scheduler_at=``),
checkpointing (``save_state``/``resume`` and the checkpoint knobs) and the
reentrant serving entry points (``prepare``/``submit``). Each raises
``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.elastic import ElasticEvent, transition_waste
from repro_torch.core.placement import Placement
from repro_torch.runtime.elastic_runner import (
    KERNEL_MODES,
    RunnerConfig,
    _validate_choice,
    not_ported,
)

from .policy import Policy
from .workload import Workload

__all__ = ["ElasticEngine", "EngineConfig", "EngineResult"]

_BACKENDS = ("simulate", "device")


@dataclass(frozen=True)
class EngineConfig:
    """Knobs shared by both backends (one config, two stacks).

    Shared:
      rows_per_tile: plan integerization granularity. 0 = derive — the
        device backend uses ``q // G`` of the staged data; the simulate
        backend defaults to 96.
      seed: base RNG seed (scenario draws, workload initialization).
      initial_speeds: the planner's step-0 speed estimates (device) /
        the plan speeds when ``plan_speeds`` is unset (simulate).

    Device backend:
      block_rows: fixed-size executor work unit (must divide rows_per_tile).
      speed_tolerance: memoized-plan reuse window under EWMA drift.
      matmul_mode: kernel route (None/"auto" = by device, "cuda", "ref").
      verify / allclose_atol: per-step output check against float64 host
        reference ("exact" | "allclose" | None).
      segmented: block-list execution mode (None = per-block loop;
        "auto"/"cuda"/"ref" = one call over every worker's block list, see
        :class:`~repro_torch.runtime.elastic_runner.RunnerConfig`).
      fuse_steps, dispatch_timeout, checkpoint_dir, checkpoint_every,
      checkpoint_on_fault, verify_results: not ported; a device engine
        raises ``NotImplementedError`` unless they keep their defaults.

    Both backends:
      arrival: ``"barrier"`` or ``"first"``. The simulate backend prices
        ``"first"`` with the ``"order"`` completion model; the device
        backend runs ``"barrier"`` only for now.
      replan: re-planning authority on the device backend — ``"central"``
        or ``"decentral"``.

    Simulate backend:
      n_draws: scenario draws per step.
      speed_mean: mean of the exponential plan-speed draw when no explicit
        speeds are given (the paper's Fig. 2 model).
      jitter_sigma: lognormal jitter of realized speeds around plan speeds.
      plan_speeds: explicit length-N planner speeds.
    """

    rows_per_tile: int = 0
    seed: int = 0
    initial_speeds: Optional[Tuple[float, ...]] = None
    # device
    block_rows: int = 16
    speed_tolerance: float = 0.10
    matmul_mode: Optional[str] = None
    verify: Optional[str] = None
    allclose_atol: float = 1e-3
    precompile_neighbors: bool = True
    plan_cache_size: Optional[int] = None
    fuse_steps: int = 1
    segmented: Optional[str] = None
    # device, not ported yet
    dispatch_timeout: Optional[float] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: Optional[int] = None
    checkpoint_on_fault: bool = False
    verify_results: Optional[str] = None
    # simulate
    n_draws: int = 1000
    speed_mean: float = 1.0
    jitter_sigma: float = 0.3
    plan_speeds: Optional[Tuple[float, ...]] = None
    # both
    arrival: str = "barrier"
    replan: str = "central"

    def __post_init__(self):
        # Arrays in a frozen dataclass break __eq__/__hash__; normalize.
        for name in ("plan_speeds", "initial_speeds"):
            v = getattr(self, name)
            if v is not None and not isinstance(v, tuple):
                object.__setattr__(
                    self, name,
                    tuple(float(s) for s in np.asarray(v).ravel()))
        _validate_choice("arrival", self.arrival, ("barrier", "first"))
        _validate_choice("replan", self.replan, ("central", "decentral"))
        _validate_choice("verify", self.verify, (None, "exact", "allclose"))
        _validate_choice("matmul_mode", self.matmul_mode, KERNEL_MODES)
        _validate_choice("segmented", self.segmented, KERNEL_MODES)
        _validate_choice("verify_results", self.verify_results,
                         (None, "off", "sample", "always"))

    @property
    def completion_model(self) -> str:
        """The :func:`simulate_batch` consume model this config prices
        under: ``"order"`` for first-arrival, ``"coverage"`` for the
        barrier."""
        return "order" if self.arrival == "first" else "coverage"


@dataclass
class EngineResult:
    """What one engine run produced — superset of both backends' outputs.

    Device runs fill ``reports`` (per-step :class:`StepReport`) and
    ``result`` (the workload's finalized object, e.g.
    :class:`PowerIterationResult`); simulate runs fill ``steps`` (per-step
    :class:`ChurnStep`) and ``completion_times`` ((T, B), +inf on
    infeasible draws). ``total_waste`` is accounted by both.
    """

    backend: str
    workload: str
    n_steps: int
    result: Any = None
    reports: List = field(default_factory=list)
    steps: List = field(default_factory=list)
    completion_times: Optional[np.ndarray] = None
    total_waste: int = 0
    churn_events: int = 0
    plans_compiled: int = 0
    cache_hits: int = 0
    executor_cache_size: int = -1
    stragglers: int = 0


class ElasticEngine:
    """Workload-agnostic elastic execution, simulated or live on the card.

    Args:
      workload: the computation (a :class:`~repro_torch.api.workload.
        Workload`).
      policy: every scheduling choice (placement, S, waste aversion, EWMA).
      cfg: backend knobs.
      backend: ``"simulate"`` or ``"device"``.
      n_machines: machine population N (used to build the policy's
        placement; not needed when ``placement`` is given).
      placement: explicit placement (overrides ``policy.make_placement``).
      clock: device backend's per-worker duration source (see
        :class:`~repro_torch.runtime.elastic_runner.HostSharedClock`).
      device: the device backend's device: None means CUDA (and raises
        when there is none); ``"cpu"`` runs the plain PyTorch versions.
    """

    def __init__(
        self,
        workload: Workload,
        policy: Policy = Policy(),
        cfg: EngineConfig = EngineConfig(),
        backend: str = "simulate",
        n_machines: Optional[int] = None,
        placement: Optional[Placement] = None,
        clock=None,
        device=None,
    ):
        if backend not in _BACKENDS:
            raise ValueError(
                f"unknown backend {backend!r}; choose from {_BACKENDS}")
        if placement is None and n_machines is None:
            raise ValueError("need n_machines (to build the policy's "
                             "placement) or an explicit placement")
        self.workload = workload
        self.policy = policy
        self.cfg = cfg
        self.backend = backend
        self.placement = (
            placement if placement is not None
            else policy.make_placement(int(n_machines))
        )
        self.clock = clock
        self.device = None
        self._runner = None  # built lazily on the first device run
        if backend == "device":
            from repro_torch.device import resolve_device

            if cfg.checkpoint_dir is not None or \
                    cfg.checkpoint_every is not None or \
                    cfg.checkpoint_on_fault:
                raise not_ported("checkpointing")
            self._rcfg = self._runner_config()
            self.device = resolve_device(device)

    # ------------------------------------------------------------------ #
    @property
    def runner(self):
        """The device backend's live runner (None before the first run)."""
        return self._runner

    def prepare(self, data: Any = None):
        raise not_ported("prepare/submit")

    def submit(self, operand: Any, event=None, stragglers=None):
        raise not_ported("prepare/submit")

    def save_state(self, directory: str, operand=None, note: str = ""):
        raise not_ported("checkpointing")

    def resume(self, directory: str, data: Any = None, path=None):
        raise not_ported("checkpointing")

    # ------------------------------------------------------------------ #
    def run(
        self,
        data: Any = None,
        n_steps: Optional[int] = None,
        events: Optional[Iterable[ElasticEvent]] = None,
        straggler_sets=None,
        operand: Optional[np.ndarray] = None,
        kill_scheduler_at: Optional[int] = None,
        faults=None,
    ) -> EngineResult:
        """Drive one elastic run through ``events``.

        Args:
          data: the workload's input (staged by ``workload.stage``). The
            simulate backend only needs shapes and may omit it.
          n_steps: step count; None consumes ``events`` to exhaustion
            (simulate). The device backend always requires one.
          events: iterable of :class:`ElasticEvent` (at most one per step);
            None means a static full-membership run.
          straggler_sets: per-step realized stragglers — an indexable of
            index collections, or a callable ``(step, membership) ->
            sequence`` evaluated after the step's event applies (device
            backend only). ``None`` (or a per-step ``None``) masks nothing.
          operand: step-0 operand override (workloads that own their
            operand ignore it).
          kill_scheduler_at, faults: fault injection, not ported yet.
        """
        if kill_scheduler_at is not None:
            raise not_ported("kill_scheduler_at")
        if faults is not None:
            raise not_ported("faults")
        if self.backend == "device":
            if n_steps is None:
                raise ValueError("the device backend needs an explicit n_steps")
            return self._run_device(data, int(n_steps), events,
                                    straggler_sets, operand)
        return self._run_simulate(n_steps, events)

    # ------------------------------------------------------------------ #
    # Device backend: live execution through the runner
    # ------------------------------------------------------------------ #
    def _runner_config(self) -> RunnerConfig:
        return RunnerConfig(
            block_rows=self.cfg.block_rows,
            stragglers=self.policy.base_stragglers(),
            gamma=self.policy.gamma,
            speed_tolerance=self.cfg.speed_tolerance,
            matmul_mode=self.cfg.matmul_mode,
            verify=self.cfg.verify,
            allclose_atol=self.cfg.allclose_atol,
            precompile_neighbors=self.cfg.precompile_neighbors,
            plan_cache_size=self.cfg.plan_cache_size,
            fuse_steps=self.cfg.fuse_steps,
            segmented=self.cfg.segmented,
            arrival=self.cfg.arrival,
            replan=self.cfg.replan,
            dispatch_timeout=self.cfg.dispatch_timeout,
            verify_results=(
                self.cfg.verify_results if self.cfg.verify_results is not None
                else self.policy.verify_results),
        )

    def _build_runner(self, data):
        from repro_torch.runtime.elastic_runner import ElasticRunner

        if data is None:
            raise ValueError("the device backend needs data to stage")
        x = self.workload.stage(data)
        runner = ElasticRunner(
            x, self.placement, self._rcfg,
            initial_speeds=self.cfg.initial_speeds,
            clock=self.clock,
            workload=self.workload,
            policy=self.policy,
            device=self.device,
        )
        if self.policy.auto_stragglers:
            self.policy.resolve_stragglers(
                runner.planning_master, runner.membership,
                jitter_sigma=self.cfg.jitter_sigma, seed=self.cfg.seed,
                commit=True, completion=self.cfg.completion_model,
            )
        return runner

    def _run_device(self, data, n_steps, events, straggler_sets,
                    operand) -> EngineResult:
        if self._runner is None:
            self._runner = self._build_runner(data)
        elif data is not None:
            # The runner staged its matrix once; silently computing on the
            # old data while accepting new data would bit-verify the wrong
            # answer. One engine, one dataset.
            raise ValueError(
                "this engine already staged data on its first run; pass "
                "data=None to continue on it, or build a new ElasticEngine "
                "for a different matrix")
        runner = self._runner
        wl = self.workload
        wl.reset()
        ev_iter = iter(events) if events is not None else None
        w = wl.init_operand(runner.rows_total, operand)

        # Runner counters accumulate over its lifetime; EngineResult reports
        # THIS run's share, so repeated run() calls don't double-count.
        base = (runner.total_waste, runner.churn_events,
                runner.plans_compiled, runner.cache_hits)
        reports: List = []
        last = None
        for i in range(n_steps):
            ev = next(ev_iter, None) if ev_iter is not None else None
            if ev is not None:
                runner.apply_event(ev)
            bad = straggler_sets
            if bad is not None:
                bad = bad(i, runner.membership) if callable(bad) else bad[i]
            y, rep = runner.step(
                w, stragglers=None if bad is None else tuple(bad))
            reports.append(rep)
            last = wl.combine(y)
            w = wl.consume(last, w)

        return EngineResult(
            backend="device",
            workload=wl.name,
            n_steps=len(reports),
            result=wl.finalize(runner, reports, last, w),
            reports=reports,
            total_waste=runner.total_waste - base[0],
            churn_events=runner.churn_events - base[1],
            plans_compiled=runner.plans_compiled - base[2],
            cache_hits=runner.cache_hits - base[3],
            executor_cache_size=runner.executor_cache_size,
            stragglers=runner.planning_master.stragglers,
        )

    # ------------------------------------------------------------------ #
    # Simulate backend: the batched analytical path
    # ------------------------------------------------------------------ #
    def _run_simulate(self, n_steps, events) -> EngineResult:
        from repro_torch.core.assignment import AssignmentSolution, solve_assignment
        from repro_torch.core.plan import compile_plan_batch
        from repro_torch.runtime.scenarios import ChurnStep, draw_scenarios, summarize
        from repro_torch.runtime.simulate import PlanStack, simulate_batch

        placement = self.placement
        N = placement.n_machines
        rows_per_tile = self.cfg.rows_per_tile or 96
        rng = np.random.default_rng(self.cfg.seed)
        if self.cfg.plan_speeds is not None:
            s_plan = np.asarray(self.cfg.plan_speeds, dtype=np.float64)
        elif self.cfg.initial_speeds is not None:
            s_plan = np.asarray(self.cfg.initial_speeds, dtype=np.float64)
        else:
            s_plan = np.maximum(rng.exponential(self.cfg.speed_mean, N), 1e-3)

        S = self.policy.base_stragglers()
        if self.policy.auto_stragglers:
            sched = self.policy.make_scheduler(placement, rows_per_tile, s_plan)
            S = self.policy.resolve_stragglers(
                sched, range(N), jitter_sigma=self.cfg.jitter_sigma,
                seed=self.cfg.seed, commit=False,
                completion=self.cfg.completion_model)

        if events is None:
            if n_steps is None:
                raise ValueError("need n_steps or events")
            full = tuple(range(N))
            events = (
                ElasticEvent(step=i, preempted=(), arrived=(), available=full)
                for i in range(n_steps)
            )

        # Two-pass batched planning: walk the trace once to collect the
        # availability sequence, solve each *unique* membership in
        # first-visit order, then compile every plan in ONE
        # compile_plan_batch call (bitwise-identical to scalar compiles,
        # so the legacy-parity guarantees hold unchanged).
        avail_seq: List[Tuple[int, ...]] = []
        churn = 0
        for i, ev in enumerate(events):
            if n_steps is not None and i >= n_steps:
                break
            # Same definition as the device backend (ElasticEvent.is_churn),
            # so the two backends' EngineResults agree on a shared trace.
            churn += int(ev.is_churn)
            avail_seq.append(tuple(sorted(ev.available)))
        if n_steps is not None and len(avail_seq) < n_steps:
            # Backend step-count parity: the device loop consumes at most
            # one event per step and keeps running on the last membership
            # once the trace is exhausted — pad identically here, so the
            # same config + a short trace reports the same n_steps either
            # way. (n_steps=None still means "to trace exhaustion".)
            pad = avail_seq[-1] if avail_seq else tuple(range(N))
            avail_seq.extend([pad] * (n_steps - len(avail_seq)))

        index_of: Dict[Tuple[int, ...], int] = {}
        sols: List[AssignmentSolution] = []
        for avail in avail_seq:
            if avail not in index_of:
                index_of[avail] = len(sols)
                # Lexicographic (balanced) solves — the SAME solver settings
                # as the device backend's Algorithm-1 master, so the two
                # backends compile identical plans for identical
                # (membership, speeds) and their waste accounting agrees
                # (asserted by the backend-parity test).
                sols.append(solve_assignment(
                    placement, s_plan, available=avail, stragglers=S))
        # Mirror the device executor's integerization: its plans are always
        # compiled at row_align == block_rows, so an analytical run over the
        # same config models the same integer row split (and therefore the
        # same transition waste) as the live run.
        row_align = (
            self.cfg.block_rows
            if self.cfg.block_rows and rows_per_tile % self.cfg.block_rows == 0
            else 1
        )
        plans = compile_plan_batch(
            placement, sols, rows_per_tile=rows_per_tile,
            stragglers=S, speeds=s_plan, row_align=row_align)
        rows_l = [
            {n: plan.rows_of(n) for n in range(N)} for plan in plans
        ]

        steps_meta = []
        prev_rows: Optional[Dict[int, set]] = None
        prev_avail: Optional[Tuple[int, ...]] = None
        total_waste = 0
        for i, avail in enumerate(avail_seq):
            idx = index_of[avail]
            rows = rows_l[idx]
            replanned = avail != prev_avail
            waste = 0
            if replanned and prev_rows is not None:
                preempted = [n for n in range(N) if n not in set(avail)]
                waste = transition_waste(prev_rows, rows, preempted)
                total_waste += waste
            prev_rows = rows
            steps_meta.append((i, avail, idx, sols[idx].c_star, replanned,
                               waste))
            prev_avail = avail

        B = self.cfg.n_draws
        if not steps_meta:
            return EngineResult(
                backend="simulate", workload=self.workload.name, n_steps=0,
                completion_times=np.zeros((0, B)), stragglers=S,
            )

        stack = PlanStack.from_batch(plans)
        T = len(steps_meta)
        plan_index = np.repeat(
            np.asarray([m[2] for m in steps_meta], dtype=np.int64), B)
        realized, _ = draw_scenarios(
            s_plan, T * B, self.cfg.jitter_sigma, rng, range(N))
        timing = simulate_batch(stack, realized, plan_index=plan_index,
                                on_infeasible="inf",
                                completion=self.cfg.completion_model)
        completion = timing.completion_times.reshape(T, B)
        scale = self.workload.cost_scale()
        if scale != 1.0:
            # Modeled work per row relative to a matvec row (e.g. MatMat's
            # column count); 1.0 keeps bitwise parity with simulate_batch.
            # c* scales identically so time/c_star ratios stay unit-free.
            completion = completion * scale

        steps = [
            ChurnStep(step=i, available=avail, c_star=c_star * scale,
                      replanned=replanned, waste=waste,
                      summary=summarize(completion[row]))
            for row, (i, avail, _, c_star, replanned, waste)
            in enumerate(steps_meta)
        ]
        return EngineResult(
            backend="simulate",
            workload=self.workload.name,
            n_steps=T,
            steps=steps,
            completion_times=completion,
            total_waste=total_waste,
            churn_events=churn,
            plans_compiled=len(plans),
            cache_hits=T - len(plans),
            stragglers=S,
        )
