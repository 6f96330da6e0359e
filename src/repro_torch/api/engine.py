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
  the engine raises unless the caller passes ``device="cpu"``. Both consume
  rules (``arrival="barrier"`` / ``"first"``) run, stepwise or in fused
  windows of ``fuse_steps`` steps. ``run(faults=...)`` injects unannounced
  failures (:mod:`repro_torch.faults`): covered losses are masked, and an
  uncovered one aborts the step, demotes the dead workers and re-executes
  the step (``kill_scheduler_at=i`` is one such fault). ``dispatch_timeout``
  and ``verify_results`` arm the runner's timeout and corruption defenses.

The device backend is also reentrant: :meth:`ElasticEngine.prepare` stages
the data once and :meth:`ElasticEngine.submit` runs one step on a
caller-provided operand (the serving layer's lanes,
:mod:`repro_torch.serve`). :meth:`ElasticEngine.save_state` /
:meth:`ElasticEngine.resume` checkpoint and restore the full resumable state
in the JAX package's checkpoint format, and the ``checkpoint_*`` knobs write
checkpoints during a run.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

import time

import numpy as np

from repro_torch.core.elastic import ElasticEvent, transition_waste
from repro_torch.core.placement import Placement
from repro_torch.runtime.elastic_runner import (
    KERNEL_MODES,
    RunnerConfig,
    _validate_choice,
)
from repro_torch.runtime.tracing import span

from .policy import Policy
from .workload import Workload

__all__ = ["ElasticEngine", "EngineConfig", "EngineResult"]

_BACKENDS = ("simulate", "device")


def _host(w):
    """An iterate carry as a host array (a device tensor is fetched)."""
    if w is None or isinstance(w, np.ndarray):
        return w
    if hasattr(w, "detach"):
        return w.detach().cpu().numpy()
    return np.asarray(w)


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
      fuse_steps: K, steps per device dispatch (1 = stepwise; K > 1 runs
        fused windows, one CUDA graph replay a window in segmented mode).
      dispatch_timeout: modeled per-dispatch deadline (seconds). A worker
        whose clocked duration exceeds it is treated as silent: masked as
        a realized straggler when the S budget covers it, demoted +
        re-executed otherwise. None disables the detector.
      max_fault_retries: recovery budget per step index — how many times
        :meth:`ElasticEngine.run` demotes + replans + re-executes one step
        after :class:`~repro_torch.faults.chaos.FaultAbort` before giving
        up and re-raising.
      verify_results: silent-corruption defense override — None inherits
        ``policy.verify_results``; ``"off"`` / ``"sample"`` / ``"always"``
        force the runner's tile-audit + Freivalds cadence (see
        :class:`~repro_torch.faults.integrity.IntegrityChecker`). The
        simulate backend ignores it.
      checkpoint_dir: where a device run writes checkpoints (None = none).
      checkpoint_every: periodic snapshot every N engine steps (fused runs
        snapshot at the first window boundary past each multiple).
      checkpoint_on_fault: also snapshot when a fault aborts a dispatch,
        before the step re-executes.

    Both backends:
      arrival: ``"barrier"`` or ``"first"``. The simulate backend prices
        ``"first"`` with the ``"order"`` completion model; the device
        backend runs the paper's first-arrival master (per-worker partials,
        the first ``N - S`` modeled arrivals consumed).
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
    # device: unannounced-failure tolerance + checkpointing
    dispatch_timeout: Optional[float] = None
    max_fault_retries: int = 3
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
        if self.dispatch_timeout is not None and self.dispatch_timeout <= 0:
            raise ValueError(
                f"dispatch_timeout must be > 0 (modeled seconds), got "
                f"{self.dispatch_timeout}")
        if self.max_fault_retries < 0:
            raise ValueError(
                f"max_fault_retries must be >= 0, got {self.max_fault_retries}")
        if self.checkpoint_every is not None and self.checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1 steps, got "
                f"{self.checkpoint_every}")
        if self.checkpoint_dir is None and (
                self.checkpoint_every is not None or self.checkpoint_on_fault):
            raise ValueError(
                "checkpoint_every / checkpoint_on_fault need a "
                "checkpoint_dir to write to")

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
    # Unannounced-failure telemetry (device runs with faults/timeouts):
    # every fired fault's FaultRecord and the number of abort→demote→
    # replan→re-execute cycles.
    fault_records: List = field(default_factory=list)
    recoveries: int = 0
    # Paths of the checkpoints this run wrote (checkpoint_every /
    # checkpoint_on_fault).
    checkpoints: List = field(default_factory=list)
    # Silent-corruption telemetry (device runs with verify_results on):
    # this run's Freivalds checks / sketch failures / tile audits and the
    # recovery actions they triggered (restaged tiles, quarantined
    # partials, rows recomputed in a fused window, graylist events).
    integrity: Dict[str, int] = field(default_factory=dict)


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
        self._last_operand = None  # last run's final carry (checkpointing)
        if backend == "device":
            from repro_torch.device import resolve_device

            self._rcfg = self._runner_config()
            self.device = resolve_device(device)

    # ------------------------------------------------------------------ #
    @classmethod
    def from_runner(cls, runner, workload: Workload) -> "ElasticEngine":
        """Adopt an already-built :class:`ElasticRunner` (the legacy
        ``run_power_iteration(runner, ...)`` calling convention), on the
        runner's device.

        The runner's executor was built for its construction-time
        workload's block function; the adopted workload must be
        executor-compatible (same block function and ``out_cols``): the
        power-iteration driver over a matvec runner is the canonical case.
        """
        eng = cls(
            workload,
            cfg=EngineConfig(
                block_rows=runner.cfg.block_rows,
                verify=runner.cfg.verify,
                allclose_atol=runner.cfg.allclose_atol,
            ),
            backend="device",
            placement=runner.placement,
            device=runner.device,
        )
        runner.workload = workload
        eng._runner = runner
        return eng

    @property
    def runner(self):
        """The device backend's live runner (None before the first run)."""
        return self._runner

    # ------------------------------------------------------------------ #
    # Reentrant stepping: the serving layer's entry points. prepare()
    # stages the data once; each submit() then drives exactly one device
    # dispatch with a caller-provided operand — the caller (a server loop)
    # owns the trace.
    # ------------------------------------------------------------------ #
    def prepare(self, data: Any = None):
        """Stage ``data`` on the device and build the live runner without
        running a step.

        Device backend only. Idempotent: a second call with ``data=None``
        is a no-op; a second call with data raises (one engine, one
        dataset — same rule as :meth:`run`). Returns the runner.
        """
        if self.backend != "device":
            raise ValueError(
                "prepare()/submit() drive live device dispatches; build the "
                "engine with backend='device'")
        if self._runner is None:
            self._runner = self._build_runner(data)
        elif data is not None:
            # The runner staged its matrix once; silently computing on the
            # old data while accepting new data would bit-verify the wrong
            # answer. One engine, one dataset.
            raise ValueError(
                "this engine already staged data; pass data=None to keep "
                "stepping on it, or build a new ElasticEngine for a "
                "different matrix")
        return self._runner

    def submit(
        self,
        operand: Any,
        event: Optional[ElasticEvent] = None,
        stragglers: Optional[Tuple[int, ...]] = None,
    ):
        """Execute ONE elastic step on ``operand``; returns
        ``(result, reports)``.

        ``event`` (if any) applies before planning; ``stragglers`` injects
        a realized set exactly like :meth:`run`'s per-step hook (None =
        derive under ``arrival="first"``, mask nothing under
        ``"barrier"``). ``result`` is the workload's combined step output
        (e.g. the full ``X @ W`` for :class:`~repro_torch.api.workload.
        MatMat`; the serving layer slices request columns out of it). When
        the engine was built with ``fuse_steps > 1`` and the workload fuses,
        the dispatch rides the fused window driver as a one-active-step
        window, the same captured program as a window of any other size.
        State (EWMA, plan cache, membership) carries across submits exactly
        as across :meth:`run` steps.
        """
        if self._runner is None:
            raise RuntimeError(
                "submit() needs a staged runner: call prepare(data) first")
        runner = self._runner
        wl = self.workload
        w = wl.init_operand(runner.rows_total, operand)
        bad = None if stragglers is None else tuple(stragglers)
        if runner.cfg.fuse_steps > 1 and runner.fuse_supported:
            runner.ingest_pending()
            _, ys, _, reports = runner.step_window(
                w, [bad], events=[event])
            y = ys[0]
        else:
            y, rep = runner.step(w, event=event, stragglers=bad)
            reports = [rep]
        with span("workload.update", runner._step):
            return wl.combine(y), reports

    # ------------------------------------------------------------------ #
    # Checkpoint / resume: the FULL resumable device-backend state — the
    # iterate carry, the EWMA speed estimates, membership, the pending
    # measurement feed, the plan-cache keys (plans are a pure function of
    # state and recompile bitwise on warm start), and the synthetic clock's
    # RNG — so a killed run continues bit for bit.
    # ------------------------------------------------------------------ #
    def save_state(self, directory: str, operand=None,
                   note: str = "") -> str:
        """Snapshot the live runner into ``directory`` (atomic; see
        :mod:`repro_torch.runtime.checkpoint`). ``operand`` is the iterate
        carry to store (a host array or a device tensor, fetched to the
        host; defaults to the last completed run's final carry). Returns
        the checkpoint path."""
        from repro_torch.runtime.checkpoint import save_checkpoint

        runner = self._runner
        if runner is None:
            raise RuntimeError(
                "no live runner to checkpoint: run() or prepare() first")
        master = runner.planning_master
        if operand is None:
            operand = self._last_operand
        has_operand = operand is not None
        tree = {
            "operand": (_host(operand) if has_operand
                        else np.zeros(0, dtype=np.float64)),
            "speeds": master.estimator.speeds,
        }
        clock_state = None
        if hasattr(runner.clock, "state_dict"):
            clock_state = runner.clock.state_dict()
        extra = {"engine": {
            "runner_step": int(runner._step),
            "membership": [int(n) for n in runner.membership],
            "measured_ever": sorted(
                int(n) for n in runner._measured_ever),
            "speed_seeded": bool(runner._speed_seeded),
            "stragglers": int(master.stragglers),
            "pending_loads": {
                str(k): float(v)
                for k, v in runner._pending_loads.items()},
            "pending_durations": {
                str(k): float(v)
                for k, v in runner._pending_durations.items()},
            "plan_cache_keys": [
                list(map(int, k)) for k in runner._plan_cache],
            "clock": clock_state,
            "last_step_wall": float(runner._last_step_wall),
            "has_operand": has_operand,
            "workload": self.workload.name,
            "note": note,
        }}
        return save_checkpoint(directory, int(runner._step), tree, extra)

    def resume(self, directory: str, data: Any = None,
               path: Optional[str] = None) -> Tuple[int, Any]:
        """Restore a :meth:`save_state` snapshot into this engine's runner
        and return ``(step, operand)``: feed ``operand`` (a host array; the
        run moves it to the device) and the remaining trace back into
        :meth:`run` to continue **bitwise-equal** to the uninterrupted run.
        The carry, the EWMA estimates, the membership, the pending
        measurement feed and the synthetic clock's RNG continue from the
        saved bits, and the plan cache warm-starts from its saved keys.
        ``path`` pins a checkpoint; the default is the directory's LATEST
        pointer. ``data`` stages the matrix when the engine has not run yet
        (same rule as :meth:`prepare`). Checkpoints written by the JAX
        package restore here too."""
        from repro_torch.runtime.checkpoint import (
            latest_checkpoint,
            restore_checkpoint,
        )

        if self.backend != "device":
            raise ValueError(
                "resume() restores the live runner; build the engine with "
                "backend='device'")
        ckpt = path if path is not None else latest_checkpoint(directory)
        if ckpt is None:
            raise FileNotFoundError(
                f"no checkpoint found under {directory!r}")
        runner = self.prepare(data)
        like = self._like_from_manifest(ckpt)
        step, tree, extra = restore_checkpoint(ckpt, like)
        eng = extra.get("engine", {})
        master = runner.planning_master
        master.estimator.load_speeds(np.asarray(tree["speeds"]))
        avail = tuple(
            int(n) for n in eng.get("membership", runner.membership))
        runner.placement.restrict(avail)  # raises if the data is gone
        runner._membership = avail
        runner._measured_ever = {
            int(n) for n in eng.get("measured_ever", ())}
        runner._speed_seeded = bool(eng.get("speed_seeded", True))
        runner._pending_loads = {
            int(k): float(v)
            for k, v in eng.get("pending_loads", {}).items()}
        runner._pending_durations = {
            int(k): float(v)
            for k, v in eng.get("pending_durations", {}).items()}
        runner._step = int(eng.get("runner_step", step))
        runner._last_step_wall = float(eng.get("last_step_wall", 1.0))
        if eng.get("stragglers") is not None:
            runner.set_stragglers(int(eng["stragglers"]))
        clock_state = eng.get("clock")
        if clock_state is not None and hasattr(runner.clock, "load_state"):
            runner.clock.load_state(clock_state)
        # Warm-start the plan cache from its saved keys: entries rebuild
        # under the restored estimator state (the LP is pure, the arrays
        # come back identical). Memberships that became infeasible since
        # the snapshot are skipped.
        runner._current = None
        for key in eng.get("plan_cache_keys", ()):
            k = tuple(int(n) for n in key)
            try:
                runner._plan_for(k)
            except Exception:
                continue
        operand = (
            np.asarray(tree["operand"])
            if eng.get("has_operand", True) else None)
        self._last_operand = operand
        return int(eng.get("runner_step", step)), operand

    @staticmethod
    def _like_from_manifest(path: str) -> Dict[str, np.ndarray]:
        """Zero prototypes matching a :meth:`save_state` checkpoint's
        leaves: the manifest records every leaf's shape and dtype, so
        restore rebuilds the tree without the caller knowing the saved
        shapes. (Engine checkpoints hold float arrays only; a widened
        bf16/fp8 leaf comes back as float32.)"""
        import json
        import os

        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        like: Dict[str, np.ndarray] = {}
        for entry in manifest["leaves"]:
            name = entry["key"].strip("[]'\"")  # keystr: "['operand']"
            try:
                dtype = np.dtype(entry["dtype"])
            except TypeError:
                dtype = np.dtype(np.float32)
            like[name] = np.zeros(tuple(entry["shape"]), dtype=dtype)
        return like

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
            backend only). ``None`` injects nothing: under
            ``arrival="first"`` the runner then derives each step's realized
            set from modeled arrival order; under ``arrival="barrier"`` no
            copies are masked. A callable may also return ``None`` per step.
          operand: step-0 operand override (workloads that own their
            operand ignore it).
          kill_scheduler_at: fault injection (device backend only) — kill
            the central scheduler immediately BEFORE planning step index
            ``kill_scheduler_at`` of this run. Under ``replan="decentral"``
            the run carries on the replicated local rule with outputs
            bitwise-equal to the uninterrupted run; under
            ``replan="central"`` the next plan raises
            :class:`~repro_torch.core.decentral.SchedulerKilledError`. It is
            one ``scheduler_kill`` :class:`~repro_torch.faults.chaos.
            FaultSpec` on the run's injector.
          faults: unannounced-failure schedule (device backend only) — a
            :class:`~repro_torch.faults.chaos.ChaosPlan`, an iterable of
            :class:`~repro_torch.faults.chaos.FaultSpec`, or a pre-built
            :class:`~repro_torch.faults.chaos.FaultInjector` (used as-is:
            its indices are absolute). Plan and spec step indices count
            steps of THIS run. Covered losses are masked as realized
            stragglers; uncovered losses abort the dispatch, the dead
            workers are demoted like a preemption, and the step re-executes
            (at most ``cfg.max_fault_retries`` times per step index) —
            outputs stay bitwise-equal to the clean run.
        """
        if self.backend == "device":
            if n_steps is None:
                raise ValueError("the device backend needs an explicit n_steps")
            with span("engine.run",
                      None if self._runner is None else self._runner._step):
                return self._run_device(data, int(n_steps), events,
                                        straggler_sets, operand,
                                        kill_scheduler_at, faults)
        if kill_scheduler_at is not None:
            raise ValueError(
                "kill_scheduler_at is a device-backend fault injection; "
                "the simulate backend has no live scheduler to kill")
        if faults is not None:
            raise ValueError(
                "faults= is a device-backend injection; the simulate "
                "backend has no live dispatches to fail")
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
                    operand, kill_scheduler_at=None,
                    faults=None) -> EngineResult:
        from repro_torch.faults.chaos import (
            FaultAbort,
            FaultInjector,
            FaultSpec,
        )

        runner = self.prepare(data)
        wl = self.workload
        wl.reset()
        ev_iter = iter(events) if events is not None else None
        w = wl.init_operand(runner.rows_total, operand)

        # Runner counters accumulate over its lifetime; EngineResult reports
        # THIS run's share, so repeated run() calls don't double-count.
        base = (runner.total_waste, runner.churn_events,
                runner.plans_compiled, runner.cache_hits)
        integrity_base = runner.integrity_snapshot()
        reports: List = []
        last = None
        fused = runner.cfg.fuse_steps > 1 and runner.fuse_supported
        kill_at = None if kill_scheduler_at is None else int(kill_scheduler_at)
        if kill_at is not None and not 0 <= kill_at < n_steps:
            raise ValueError(
                f"kill_scheduler_at={kill_at} outside this run's step range "
                f"[0, {n_steps})")
        # Engine step i of this run is the runner's absolute step base0+i:
        # the injector and the window-break peeks speak absolute indices.
        base0 = runner._step
        inj = FaultInjector.coerce(faults, base_step=base0)
        if kill_at is not None:
            # The scheduler kill is one fault kind of the chaos schedule:
            # same injection point (before step kill_at plans).
            if inj is None:
                inj = FaultInjector(base_step=base0)
            inj.add(FaultSpec("scheduler_kill", kill_at))
        if inj is None and self.cfg.dispatch_timeout is not None \
                and runner.fault_injector is None:
            # Timeouts are detected runner-side but *recorded* through the
            # injector: install an empty one so a fault-free timed run
            # still reports its masked/demoted workers in fault_records.
            inj = FaultInjector(base_step=base0)
        if inj is not None:
            runner.fault_injector = inj
        inj = runner.fault_injector
        log_base = 0 if inj is None else len(inj.log)

        # Events are consumed from the iterator EXACTLY once per step index
        # and replayed from this cache when a faulted step re-executes —
        # an aborted window must not eat trace events.
        ev_cache: Dict[int, Optional[ElasticEvent]] = {}

        def ev_for(j: int) -> Optional[ElasticEvent]:
            if j not in ev_cache:
                ev_cache[j] = (
                    next(ev_iter, None) if ev_iter is not None else None)
            return ev_cache[j]

        # Workers demoted by fault recovery: the trace doesn't know they
        # died, so its later events are filtered against this set (and an
        # explicit `arrived` revives — the machine came back). Preempted/
        # arrived are recomputed against the live membership so retried
        # events stay idempotent.
        dead: set = set()

        def filt(ev: Optional[ElasticEvent]) -> Optional[ElasticEvent]:
            if ev is None or not dead:
                return ev
            dead.difference_update(ev.arrived)
            avail = tuple(sorted(set(ev.available) - dead))
            cur = set(runner.membership)
            return ElasticEvent(
                step=ev.step,
                preempted=tuple(sorted(cur - set(avail))),
                arrived=tuple(sorted(set(avail) - cur)),
                available=avail,
            )

        def demote(step: int, gone) -> None:
            # A synthesized preemption of the dead workers.
            dead.update(gone)
            cur = set(runner.membership)
            runner.apply_event(ElasticEvent(
                step=step, preempted=tuple(sorted(set(gone) & cur)),
                arrived=(), available=tuple(sorted(cur - set(gone)))))

        def drain_demotions(i: int) -> None:
            # A covered crash was masked as a realized straggler; its
            # demotion lands before the next step, exactly like an
            # announced event one step late.
            if runner.pending_demotions:
                gone = set(runner.pending_demotions)
                runner.pending_demotions.clear()
                demote(base0 + i, gone)

        def step_bad_of(i: int, membership) -> Optional[Tuple[int, ...]]:
            # None = "no injection": the runner masks nothing (barrier) or
            # derives the realized set from arrival order (first).
            if straggler_sets is None:
                return None
            got = (straggler_sets(i, membership) if callable(straggler_sets)
                   else straggler_sets[i])
            return None if got is None else tuple(got)

        recoveries = 0
        checkpoints: List[str] = []
        ckpt_every = self.cfg.checkpoint_every
        retries: Dict[int, int] = {}
        recover_t0: Dict[int, float] = {}

        def checkpoint(w_carry, tag: str) -> None:
            if self.cfg.checkpoint_dir is None:
                return
            checkpoints.append(self.save_state(
                self.cfg.checkpoint_dir, operand=w_carry, note=tag))

        def recover(fa: FaultAbort, i: int, w_carry) -> None:
            # The abort fired BEFORE anything dispatched: the carry is
            # valid, nothing partial was consumed. Demote the dead workers
            # as if a preemption event had arrived, optionally snapshot,
            # and let the loop re-plan + re-execute the same step index.
            # Only FaultAbort gets here: a kernel or CUDA error propagates.
            nonlocal recoveries
            n = retries.get(i, 0) + 1
            retries[i] = n
            if n > self.cfg.max_fault_retries:
                raise fa
            recoveries += 1
            recover_t0.setdefault(i, time.perf_counter())
            if fa.demote:
                demote(fa.step, fa.demote)
            if self.cfg.checkpoint_on_fault:
                checkpoint(w_carry, f"on-fault: {fa.kind} @ step {fa.step}")

        def settle_recovery(i: int) -> None:
            # The re-executed step completed: stamp the measured host-side
            # abort→replan→re-execute latency onto the demotion records.
            t0 = recover_t0.pop(i, None)
            if t0 is None or inj is None:
                return
            dt = time.perf_counter() - t0
            for rec in inj.log:
                if rec.action == "demoted" and rec.recover_s == 0.0:
                    rec.recover_s = dt

        if fused:
            # Window loop: up to K steps per dispatch. Events are consumed
            # step-aligned; churn onto a membership whose plan is already
            # cached stays IN-window (per-step plans are data). A plan-cache
            # miss (or past-tolerance drift) FLUSHES the window early, so
            # the steps assembled so far dispatch at once and the solve runs
            # at the next window's head. A step with a scheduled fault
            # always lands at a window HEAD (assembly breaks before it): an
            # uncovered loss then aborts before the window draws any clock
            # samples, so the retry replays an identical window.
            K = runner.cfg.fuse_steps
            w_carry = w
            i = 0
            while i < n_steps:
                # Fold the previous window's measurements into the EWMA
                # BEFORE assembling this one, so plan_is_ready (the flush
                # rule) and the in-window _plan_for judge drift against the
                # same estimator state.
                runner.ingest_pending()
                drain_demotions(i)
                ev = filt(ev_for(i))
                membership = (tuple(sorted(ev.available)) if ev is not None
                              else runner.membership)
                evs: List = [ev]
                sets = [step_bad_of(i, membership)]
                j = i + 1
                while j < n_steps and len(sets) < K:
                    if inj is not None and inj.has_fault(base0 + j):
                        # Break so the fault fires at the next window's
                        # head — an abort there discards nothing.
                        break
                    ev_j = filt(ev_for(j))
                    if ev_j is not None:
                        new_mem = tuple(sorted(ev_j.available))
                        if ((ev_j.is_churn or new_mem != membership)
                                and not runner.plan_is_ready(new_mem)):
                            break  # flush: solve off-window
                        membership = new_mem
                    evs.append(ev_j)
                    sets.append(step_bad_of(j, membership))
                    j += 1
                try:
                    w_carry, ys, ws, reps = runner.step_window(
                        w_carry, sets, events=evs)
                except FaultAbort as fa:
                    recover(fa, i, w_carry)
                    continue
                settle_recovery(i)
                reports.extend(reps)
                # Replay the host-side fold on the window outputs: combine +
                # consume give the per-step results/statistics exactly as
                # stepwise; consume's operand is discarded — the card
                # already carried the (bitwise-identical) iterate.
                for k in range(len(sets)):
                    with span("workload.update", base0 + i + k):
                        last = wl.combine(ys[k])
                        wl.consume(last, ws[k])
                i_prev, i = i, i + len(sets)
                # Window-boundary-aligned periodic snapshot: fire when the
                # window crossed a checkpoint_every boundary.
                if ckpt_every is not None and (
                        i // ckpt_every > i_prev // ckpt_every):
                    checkpoint(w_carry, f"periodic @ engine step {i}")
            w = _host(w_carry)
        else:
            i = 0
            while i < n_steps:
                with span("engine.step", base0 + i):
                    drain_demotions(i)
                    ev = filt(ev_for(i))
                    if ev is not None:
                        runner.apply_event(ev)
                    try:
                        y, rep = runner.step(
                            w, stragglers=step_bad_of(i, runner.membership))
                    except FaultAbort as fa:
                        recover(fa, i, w)
                        continue
                    settle_recovery(i)
                    reports.append(rep)
                    with span("workload.update", base0 + i):
                        last = wl.combine(y)
                        w = wl.consume(last, w)
                i += 1
                if ckpt_every is not None and i % ckpt_every == 0:
                    checkpoint(w, f"periodic @ engine step {i}")

        self._last_operand = w
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
            fault_records=[] if inj is None else list(inj.log[log_base:]),
            recoveries=recoveries,
            checkpoints=checkpoints,
            integrity={
                k: v - integrity_base.get(k, 0)
                for k, v in runner.integrity_snapshot().items()},
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
