"""Live elastic execution on the card: the churn-driven device backend.

The port of :mod:`repro.runtime.elastic_runner`. It closes the loop the
paper runs on EC2 (§V): an
:class:`~repro_torch.core.elastic.AvailabilityTrace` feeds
:class:`~repro_torch.core.elastic.ElasticEvent`\\ s into a master that

1. re-estimates worker speeds (EWMA, Algorithm 1 line 4) from *measured*
   per-worker step times of the previous step,
2. re-plans on membership change — compiled plans are **memoized per
   membership** and invalidated only when the speed estimate drifts past a
   tolerance, so revisited availability states reuse their plan in O(N),
3. executes the step through the single-card executor
   (:func:`repro_torch.runtime.executor.make_matvec_executor`) with the
   *workload's* per-block compute as the kernel — the hand-written
   ``usec_matvec`` kernel per block, or one ``usec_segmented`` launch for
   every worker's block list (``segmented=``).

Two consume rules (``RunnerConfig.arrival``): ``"barrier"`` combines every
included worker's partials in one executor call, while ``"first"`` is the
paper's first-arrival master — each loaded worker's partial is dispatched on
its own CUDA stream with its own event, the first ``N_t - S`` modeled
arrivals are consumed, the realized slowest-S set is masked out of a
host-side winner-gather combine, and every late worker's duration still
feeds the EWMA. ``fuse_steps = K > 1`` runs windows of K steps in one
dispatch (:meth:`ElasticRunner.step_window`): include weights and the
iterate update stay on the card, and in segmented mode the window is one
CUDA graph replay.

The static-shape contract: every array is padded to the **max-N membership**
(the full machine population). A preempted machine is a worker slot with
``n_blocks == 0`` and all-zero include weights. Membership changes therefore
swap plan arrays; the executors are built once per runner, the window graph
is captured once, and the kernel library is loaded once per process
(:attr:`ElasticRunner.executor_cache_size` stays at 1, the reference's
jit-cache telemetry).

Per-worker step times: a single card cannot observe heterogeneous worker
speeds, so the runner takes a pluggable clock — :class:`HostSharedClock`
apportions the measured step wall time by row share, and
:class:`SyntheticSpeedClock` replays a heterogeneous speed process so runs
exercise the EWMA adaptation reproducibly. Real step wall time (host clock
around a synchronized executor call) is always measured and reported.

Unannounced failures (:mod:`repro_torch.faults`) fire at the reference's
seams through :attr:`ElasticRunner.fault_injector`: planning faults at a
step's head, dispatch faults (crash, result drop) classified against the S
budget before anything dispatches (covered: masked as realized stragglers;
not covered: :class:`~repro_torch.faults.chaos.FaultAbort` for the engine's
demote → replan → re-execute loop), ``dispatch_timeout`` on the modeled
durations, and the silent-corruption defense of ``verify_results``: a tile
audit of the copy the kernels read (on the card one ``tile_checksum`` launch
over the card's staged buffer, on the host zlib over the host copy) with
in-place re-staging from a clean replica, and Freivalds checks of the
fetched results with a masked re-dispatch through the same executor
(barrier), a realized straggler (first-arrival) or a recompute of the
corrupt rows from a replica tile (fused windows; on the card one
``usec_matvec`` launch a row chunk). Observers registered with
:meth:`ElasticRunner.add_completion_callback` see every executed step's
report once, in order (the serving layer's metrics feed). This module imports
torch only when a runner is built, so the host-side classes work without it.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.elastic import ElasticEvent, transition_waste
from repro_torch.core.placement import LostTileError, Placement
from repro_torch.core.scheduler import StepPlan

__all__ = [
    "ElasticRunner",
    "HostSharedClock",
    "PowerIterationResult",
    "RunnerConfig",
    "StepReport",
    "SyntheticSpeedClock",
    "make_exact_matrix",
    "quantize_unit",
    "unit_vector",
]

# The kernel routes of repro_torch.kernels.ops (None/"auto" = by device).
KERNEL_MODES = (None, "auto", "cuda", "ref")


# ---------------------------------------------------------------------- #
# Configuration / per-step report
# ---------------------------------------------------------------------- #
@dataclass(frozen=True)
class RunnerConfig:
    """Knobs of the live runner.

    block_rows: fixed-size work unit of the executor; must divide
      rows_per_tile (plans are compiled with ``row_align == block_rows``).
    stragglers: straggler tolerance S baked into every plan (superseded by
      an explicit ``policy=`` on the runner).
    gamma: EWMA mixing factor for the speed estimator (ditto).
    speed_tolerance: a memoized plan for a revisited membership is reused
      while ``max_n |s_hat[n]/s_plan[n] - 1| <= speed_tolerance`` over the
      available machines; past that drift, a cheap fresh solve prices the
      re-plan and the old plan is kept (re-baselined) unless it is more
      than ``speed_tolerance`` slower than the new optimum.
    matmul_mode: kernel route handed to the workload's ``executor_fn``
      (None/"auto" = the CUDA kernel on the card, the plain version on the
      host; "cuda" or "ref" force one).
    verify: per-step output check against a float64 host reference —
      ``"exact"`` (bitwise; integer-valued data), ``"allclose"``, or None.
      The check itself is the workload's ``verify``.
    allclose_atol: tolerance of the ``"allclose"`` mode.
    precompile_neighbors: after any step that had to compile a fresh plan,
      speculatively batch-compile every single-preemption / single-arrival
      neighbor of the adopted membership (one
      :meth:`USECScheduler.plan_batch` call, off the step critical path) so
      the next churn event is a plan-cache *hit*.
    plan_cache_size: LRU cap on memoized plans (entries); None keeps the
      cache unbounded.
    fuse_steps: K, iterations per device dispatch. 1 is the stepwise path;
      K > 1 runs windows of K steps through the fused driver
      (:meth:`ElasticRunner.step_window`): the iterate update and straggler
      include masks stay on the card, so a window costs one dispatch and
      one result fetch for K steps. Windows are always K long (flushed and
      tail steps are inactive padding), so the segmented mode captures its
      window as ONE CUDA graph for the whole run.
    segmented: per-worker block-list execution — None keeps the per-block
      loop (one ``usec_matvec`` launch per real block); "auto"/"cuda"/"ref"
      route every worker's whole block list through the workload's
      ``segmented_fn`` (one ``usec_segmented`` launch a step on the card).
    arrival: the master's consume rule. ``"barrier"`` combines every
      included worker in one executor call. ``"first"`` is the paper's
      first-arrival master: each loaded worker's unmasked partial is
      dispatched on its own CUDA stream
      (:func:`repro_torch.runtime.executor.make_worker_executor`), the master
      consumes the first ``N_t - S`` completions in modeled arrival order
      (the clock's durations, never event timings), masks the realized
      slowest-S set through the ordinary include weights and gathers each
      row from its winner; late workers' durations still feed the EWMA.
      Modeled completion is the (N_t - S)-th order statistic. At S = 0 it
      reduces to the barrier bitwise. Composes with ``fuse_steps > 1``:
      fused windows derive each step's realized set at assembly time.
    replan: ``"central"`` routes every planning call through the
      Algorithm-1 master; ``"decentral"`` evaluates the pure local rule of
      :mod:`repro_torch.core.decentral` over replicated state (plans are
      bitwise-identical, and :meth:`ElasticRunner.kill_scheduler` mid-run
      does not stop the job).
    dispatch_timeout: modeled per-dispatch deadline (seconds). A worker
      whose clocked duration exceeds it is silent for this step: masked as
      a realized straggler (one re-dispatch without it under the barrier)
      when the S budget covers it, :class:`~repro_torch.faults.chaos.
      FaultAbort` otherwise. None disables the detector.
    verify_results: silent-corruption defense (``"off"`` | ``"sample"``
      | ``"always"``). On verified steps the runner (1) audits every
      staged replica tile of the copy the kernels read (the card's, by
      the ``tile_checksum`` kernel; the host copy on the CPU) against its
      staging-time CRC32 and re-stages a corrupt tile from a surviving
      replica holder whose copy still matches, on the host and in place
      on the card, and (2) Freivalds-checks the step
      output against seeded ±1 sketches of X (linear workloads; see
      :class:`repro_torch.faults.integrity.IntegrityChecker`). A corrupt
      partial is discarded (first-arrival: realized straggler; barrier:
      masked + re-dispatched through the same executor; fused: rows
      recomputed from a replica tile, by the kernel on the card), its
      timing is censored
      from the EWMA, and repeat offenders are graylisted. ``"sample"``
      verifies every :data:`repro_torch.faults.integrity.SAMPLE_PERIOD`-th
      step.
    """

    block_rows: int = 16
    stragglers: int = 0
    gamma: float = 0.5
    speed_tolerance: float = 0.10
    matmul_mode: Optional[str] = None
    verify: Optional[str] = None
    allclose_atol: float = 1e-3
    precompile_neighbors: bool = True
    plan_cache_size: Optional[int] = None
    fuse_steps: int = 1
    segmented: Optional[str] = None
    arrival: str = "barrier"
    replan: str = "central"
    dispatch_timeout: Optional[float] = None
    verify_results: str = "off"

    def __post_init__(self):
        # String knobs fail HERE, at construction, naming the allowed set.
        _validate_choice("arrival", self.arrival, ("barrier", "first"))
        _validate_choice("replan", self.replan, ("central", "decentral"))
        _validate_choice("verify", self.verify,
                         (None, "exact", "allclose"))
        _validate_choice("matmul_mode", self.matmul_mode, KERNEL_MODES)
        _validate_choice("segmented", self.segmented, KERNEL_MODES)
        _validate_choice("verify_results", self.verify_results,
                         ("off", "sample", "always"))
        if self.dispatch_timeout is not None and self.dispatch_timeout <= 0:
            raise ValueError(
                f"dispatch_timeout must be > 0 (modeled seconds), got "
                f"{self.dispatch_timeout}")


def _validate_choice(name: str, value, allowed) -> None:
    """Raise ValueError naming the bad value and the allowed set."""
    if value not in allowed:
        raise ValueError(
            f"{name} must be one of {allowed}, got {value!r}")


@dataclass
class StepReport:
    """Telemetry of one executed elastic step."""

    step: int
    available: Tuple[int, ...]
    replanned: bool            # a different plan took effect this step
    plan_cache_hit: bool       # ... and it came from the membership cache
    replan_s: float            # host-side planning latency (solve+compile or cache swap)
    wall_s: float              # measured device step wall time (synchronized)
    modeled_completion: float  # max over loaded workers of clocked duration
    straggled: Tuple[int, ...]
    waste: int                 # transition waste vs the previous step's plan
    jit_cache_size: int        # programs run or captured so far (stays 1)
    measured: Dict[int, float] # per-worker durations fed to the EWMA next step
    speeds_hat: np.ndarray     # estimator state the plan was built under


# ---------------------------------------------------------------------- #
# Per-worker clocks
# ---------------------------------------------------------------------- #
class HostSharedClock:
    """Per-worker durations on a shared device: wall time × row share.

    One card runs every worker's blocks, so worker n's slice of the measured
    wall clock is (to first order) its share of the total assigned rows. The
    induced throughput ``nu_n = load_n / duration_n`` is equal across
    workers, so the EWMA converges to uniform speeds.

    Clocks receive per-worker **row** loads (not tile units): row counts
    mean the same thing under every placement, so modeled completion times
    are comparable across placements with different tile sizes.
    """

    def durations(
        self, row_loads: np.ndarray, available: Sequence[int], wall: float
    ) -> Dict[int, float]:
        loaded = [n for n in available if row_loads[n] > 0]
        total = float(sum(row_loads[n] for n in loaded))
        if total <= 0:
            return {}
        return {n: wall * float(row_loads[n]) / total for n in loaded}


class SyntheticSpeedClock:
    """Replays a heterogeneous speed process: duration = row-load / speed.

    Speeds are in rows per second. Models the paper's EC2 observation
    (persistently different speeds with per-step jitter) on a device that
    cannot produce real heterogeneity. The realized per-step speed vectors
    are recorded in :attr:`history`.
    """

    def __init__(
        self,
        base: Sequence[float],
        jitter_sigma: float = 0.0,
        drift_sigma: float = 0.0,
        seed: int = 0,
    ):
        from .simulate import SpeedProcess

        self.process = SpeedProcess(
            base=np.asarray(base, dtype=np.float64),
            jitter_sigma=jitter_sigma,
            drift_sigma=drift_sigma,
            seed=seed,
        )
        self.history: List[np.ndarray] = []

    def durations(
        self, row_loads: np.ndarray, available: Sequence[int], wall: float
    ) -> Dict[int, float]:
        s = self.process.sample()
        self.history.append(s)
        return {
            n: float(row_loads[n]) / float(s[n])
            for n in available
            if row_loads[n] > 0
        }

    def state_dict(self) -> Dict:
        """JSON-able snapshot of the speed process (PCG64 RNG state, drift
        vector, draw count). A checkpoint stores it so a resumed run draws
        the same realized speeds an uninterrupted run would have, and every
        plan decision continues bit for bit."""
        return {
            "rng": self.process._rng.bit_generator.state,
            "drift": [float(v) for v in self.process._drift],
            "draws": len(self.history),
        }

    def load_state(self, state: Dict) -> None:
        """Restore :meth:`state_dict` output (history restarts empty: the
        draw count lives in the RNG state)."""
        self.process._rng.bit_generator.state = state["rng"]
        self.process._drift = np.asarray(state["drift"], dtype=np.float64)


# ---------------------------------------------------------------------- #
# The runner
# ---------------------------------------------------------------------- #
@dataclass
class _CacheEntry:
    step_plan: StepPlan
    block: "object"                    # BlockPlan
    include0: np.ndarray               # no-straggler include weights
    rows: Dict[int, Set[int]]          # global rows per machine (waste accounting)
    s_plan: np.ndarray                 # estimator state the plan was built under
    block_loads: np.ndarray            # (N,) tile-unit loads derived from blocks
    dev: "object"                      # DevicePlan: the plan arrays on device
    stragglers: int                    # tolerance S the plan was compiled under


class ElasticRunner:
    """Executes one workload's steps across an elastic availability trace.

    Build once per (matrix, placement); then per step optionally apply an
    :class:`ElasticEvent` and call :meth:`step`. The device state (staged
    matrix, executor) is built in ``__init__`` and never rebuilt.

    ``workload`` supplies the per-block compute and the verification
    reference (default: plain matvec); ``policy`` configures the scheduler
    (default: a Policy carrying the cfg's ``stragglers``/``gamma``).
    ``device`` is where the staged matrix lives and the kernels run: CUDA
    unless the caller names another (``"cpu"`` runs the plain versions);
    with no CUDA device and no explicit choice the constructor raises.
    """

    def __init__(
        self,
        x: np.ndarray,
        placement: Placement,
        cfg: RunnerConfig = RunnerConfig(),
        initial_speeds: Optional[Sequence[float]] = None,
        clock=None,
        workload=None,
        policy=None,
        device=None,
    ):
        import torch

        from repro_torch.device import resolve_device

        from .executor import (
            make_fused_executor,
            make_matvec_executor,
            make_worker_executor,
            stage_matrix,
        )

        self.device = resolve_device(device)
        if workload is None:
            from repro_torch.api.workload import MatVec

            workload = MatVec()
        if policy is None:
            from repro_torch.api.policy import Policy

            policy = Policy(stragglers=cfg.stragglers, gamma=cfg.gamma,
                            replan=cfg.replan)
        self.workload = workload
        self.policy = policy
        self.cfg = cfg
        self.placement = placement
        N, G = placement.n_machines, placement.n_tiles
        q, _ = x.shape
        if q % G:
            raise ValueError(f"X has {q} rows, not a multiple of G={G} tiles")
        self.rows_per_tile = q // G
        if self.rows_per_tile % cfg.block_rows:
            raise ValueError(
                f"block_rows={cfg.block_rows} must divide rows_per_tile="
                f"{self.rows_per_tile}"
            )
        self.rows_total = q
        s0 = (
            np.ones(N) if initial_speeds is None
            else np.asarray(initial_speeds, dtype=np.float64)
        )
        # Clocks and callers speak rows/second; the EWMA's measurements
        # arrive in tile-units/second (the LP's unit: block_loads / wall).
        # Seed the estimator in the measurement unit (the LP itself is
        # scale-invariant, so step-0 plans keep their ratios).
        self.scheduler = policy.make_scheduler(
            placement,
            rows_per_tile=self.rows_per_tile,
            initial_speeds=s0 / self.rows_per_tile,
            row_align=cfg.block_rows,
            kind="central",
        )
        # The PLANNING MASTER is what the live path consults: the
        # Algorithm-1 scheduler in central mode, one worker's replica of the
        # pure local rule + plan table in decentral mode (the central
        # scheduler is then a cold standby kill_scheduler() can remove).
        self.replan_mode = (
            "decentral"
            if "decentral" in (cfg.replan, getattr(policy, "replan", "central"))
            else "central"
        )
        if self.replan_mode == "decentral":
            self._master = policy.make_scheduler(
                placement,
                rows_per_tile=self.rows_per_tile,
                initial_speeds=s0 / self.rows_per_tile,
                row_align=cfg.block_rows,
                kind="decentral",
            )
        else:
            self._master = self.scheduler
        self.scheduler_killed = False
        self.clock = clock if clock is not None else HostSharedClock()
        # Static block capacity: a worker never computes more rows than it
        # stores, so stored-tiles * rows_per_tile / block_rows bounds its
        # trip count for EVERY membership — one (N, B) shape for the run.
        z = placement.storage_sets()
        self.b_max = max(len(zn) for zn in z) * (self.rows_per_tile // cfg.block_rows)

        self._staged = stage_matrix(x, placement, self.rows_per_tile)
        seg_fn = None
        if cfg.segmented is not None:
            seg_mode = None if cfg.segmented == "auto" else cfg.segmented
            seg_fn = workload.segmented_fn(seg_mode,
                                           block_rows=cfg.block_rows)
        mm = self._matmul = workload.executor_fn(cfg.matmul_mode)
        self._executor = make_matvec_executor(
            rows_total=q, block_rows=cfg.block_rows, matmul=mm,
            out_cols=workload.out_cols, segmented_fn=seg_fn,
        )
        # First-arrival dispatches per-worker partials instead of the
        # all-worker step; the worker id is an argument, so one executor
        # serves every worker.
        self._worker_exec = None
        if cfg.arrival == "first":
            self._worker_exec = make_worker_executor(
                rows_total=q, block_rows=cfg.block_rows, matmul=mm,
                out_cols=workload.out_cols, segmented_fn=seg_fn,
            )
        self._worker_streams = None   # one CUDA stream per worker, lazily
        # The fused window driver shares the stepwise body; the workload's
        # fused_update is the on-device iterate step. None means the
        # workload cannot fuse: callers fall back to stepwise dispatch.
        self._fused = None
        self.fuse_supported = True
        if cfg.fuse_steps > 1:
            upd = workload.fused_update(cfg.matmul_mode)
            if upd is None:
                self.fuse_supported = False
            else:
                self._fused = make_fused_executor(
                    rows_total=q, block_rows=cfg.block_rows,
                    fuse_steps=cfg.fuse_steps, matmul=mm,
                    out_cols=workload.out_cols, update=upd,
                    segmented_fn=seg_fn,
                )
        # Stepwise drivers that have run (the reference's jit cache grows
        # at a driver's first call); the fused driver counts its own.
        self._drivers_run: Set[str] = set()
        # Staged X goes to the device once; plan arrays once per cache entry.
        self._staged_dev = torch.as_tensor(self._staged.staged,
                                           device=self.device)
        self._completion_callbacks: List = []

        # With an explicit prior we trust its ratios; with the all-ones
        # default a never-measured machine carries no information, so it is
        # pinned at the measured fleet's geometric mean until it reports.
        self._speed_seeded = initial_speeds is not None
        self._measured_ever: Set[int] = set()
        self._x64 = x.astype(np.float64) if cfg.verify else None
        self._plan_cache: "OrderedDict[Tuple[int, ...], _CacheEntry]" = OrderedDict()
        self._membership: Tuple[int, ...] = tuple(range(N))
        self._current: Optional[_CacheEntry] = None
        self._pending_loads: Dict[int, float] = {}
        self._pending_durations: Dict[int, float] = {}
        self._step = 0
        self.device_dispatches = 0    # executor calls
        self.churn_events = 0
        self.plans_compiled = 0       # every solve+compile, incl. speculative
        self.plans_precompiled = 0    # ... of which were neighbor precompiles
        self.plans_evicted = 0        # LRU evictions from the plan cache
        self.cache_hits = 0
        self.probe_solves = 0         # drift-gate c* pricing solves
        self.precompile_s = 0.0       # host time spent off the critical path
        self.total_waste = 0
        # Wall estimate for assembly-time clock draws in fused first-arrival
        # windows (realized sets must be known before dispatch). Clocks that
        # matter for reproducibility (SyntheticSpeedClock) ignore the wall.
        self._last_step_wall = 1.0
        # Unannounced-failure seams (repro_torch.faults): the injector is
        # consulted at each step's head; pending_demotions collects workers
        # whose covered crash was masked this step — the engine turns them
        # into a synthesized preemption before the next step. Uncovered
        # faults raise FaultAbort before anything dispatches.
        self.fault_injector = None
        self.pending_demotions: Set[int] = set()
        # Silent-corruption defense (cfg.verify_results): tile fingerprints
        # and Freivalds sketch products built from the SAME host bits the
        # card holds, so a clean run can never disagree with its checker.
        self._integrity = None
        if cfg.verify_results != "off":
            from repro_torch.faults.integrity import IntegrityChecker

            self._integrity = IntegrityChecker(
                x,
                staged=self._staged.staged,
                slot_of=self._staged.slot_of,
                holders=placement.holders,
                block_rows=cfg.block_rows,
                linear=getattr(workload, "linear", False),
                exact=(cfg.verify == "exact"),
            )
            if self.device.type == "cuda":
                # The card's copy is what the kernels read and what the
                # audit checks: it must start out equal to the host bits
                # the fingerprints were taken from. A mismatch is a bad
                # upload or a broken kernel, not a fault to recover from.
                bad = self._integrity.tile_mismatches(
                    None, sums=self._card_sums())
                if bad:
                    raise RuntimeError(
                        f"tile_checksum of the card's staged buffer != the "
                        f"staging fingerprints at (worker, slot, tile) {bad}")
        # Injected-but-undetected corruption specs by worker: consumed at
        # the injection seam, recorded when (if) the defense catches them.
        self._live_tile_specs: Dict[int, object] = {}
        self._live_result_specs: Dict[int, object] = {}
        self.integrity = {
            "restaged": 0,
            "quarantined": 0,
            "repaired_rows": 0,
            "graylist_events": 0,
        }

    def integrity_snapshot(self) -> Dict[str, int]:
        """Integrity counters: runner-side recovery counts plus the
        checker's check/failure/audit totals (zeros when off)."""
        out = dict(self.integrity)
        if self._integrity is not None:
            out.update(self._integrity.counters())
        else:
            out.update({"checks": 0, "sketch_failures": 0,
                        "tile_audits": 0})
        return out

    def add_completion_callback(self, cb) -> None:
        """Register ``cb(reports: List[StepReport])`` to fire once per
        dispatch: with ``[report]`` on the stepwise and first-arrival paths,
        with the window's per-active-step reports on the fused path.
        Observers see every executed step exactly once, in step order."""
        self._completion_callbacks.append(cb)

    def remove_completion_callback(self, cb) -> None:
        self._completion_callbacks.remove(cb)

    def _notify_completion(self, reports) -> None:
        for cb in self._completion_callbacks:
            cb(reports)

    # ------------------------------------------------------------------ #
    @property
    def membership(self) -> Tuple[int, ...]:
        return self._membership

    @property
    def current_plan(self):
        """The :class:`~repro_torch.core.plan.CompiledPlan` of the last
        executed step (None before the first step)."""
        return None if self._current is None else self._current.step_plan.plan

    @property
    def planning_master(self):
        """The object the live path consults for every planning decision:
        the central :class:`USECScheduler` in ``replan="central"`` mode,
        a :class:`~repro_torch.core.decentral.DecentralPlanner` replica in
        ``replan="decentral"`` mode. Telemetry must read THIS, not
        :attr:`scheduler` — after a :meth:`kill_scheduler` the latter is a
        tombstone."""
        return self._master

    def kill_scheduler(self, reason: str = "fault injection") -> None:
        """Kill the central scheduler mid-run (fault injection).

        :attr:`scheduler` is replaced by a tombstone whose every attribute
        access raises :class:`~repro_torch.core.decentral.
        SchedulerKilledError`. In ``replan="central"`` mode the planning
        master IS the scheduler, so the very next planning decision fails
        loudly. In ``replan="decentral"`` mode the live path never touches
        the master — the run continues on the replicated rule/table,
        bitwise-identical to an uninterrupted run."""
        from repro_torch.core.decentral import DeadScheduler

        dead = DeadScheduler(reason)
        if self._master is self.scheduler:
            self._master = dead
        self.scheduler = dead
        self.scheduler_killed = True

    def set_stragglers(self, stragglers: int) -> None:
        """Re-commit the straggler tolerance S mid-run. Mirrors what
        ``select_straggler_tolerance(commit=True)`` does to the masters:
        ``t_max`` re-derives unless it was pinned explicitly, and every
        memoized plan compiled under the old S is evicted lazily by the
        stale-S gate in :meth:`_plan_for`."""
        s = int(stragglers)
        if s < 0:
            raise ValueError(f"stragglers must be >= 0, got {s}")
        targets = [self._master]
        if not self.scheduler_killed and self.scheduler is not self._master:
            targets.append(self.scheduler)
        for m in targets:
            if m.stragglers == s:
                continue
            m.stragglers = s
            if not m._t_max_explicit:
                m.t_max = m._derive_t_max()

    def invalidate_plan_state(self) -> int:
        """Drop every replicated planning artifact: the memoized plan cache
        and — in decentral mode — the replicated
        :class:`~repro_torch.core.decentral.PlanTable`. Plans are a pure
        function of (membership, speed snapshot, S), so the next step
        re-solves and produces the same bits. Returns the number of
        decentral table entries dropped (0 in central mode)."""
        self._plan_cache.clear()
        n = 0
        table = getattr(self._master, "table", None)
        if table is not None:
            n = len(table)
            table.clear()
        return n

    @property
    def executor_cache_size(self) -> int:
        """Programs this runner has run or captured, the port's analog of
        the reference's jit cache size (expected: 1 forever — a fused run
        uses only the window driver, whose segmented mode captures one CUDA
        graph; a stepwise run only the per-step executor; a first-arrival
        run only the per-worker partial; churn and worker identity are
        data). The kernel library itself loads once per process."""
        fused = 0 if self._fused is None else self._fused.cache_size
        return len(self._drivers_run) + fused

    @property
    def window_graph_replays(self) -> int:
        """CUDA graph replays of the fused window driver (one per window in
        segmented mode on the card; 0 otherwise)."""
        return 0 if self._fused is None else self._fused.replays

    def apply_event(self, ev: ElasticEvent) -> None:
        """Adopt the event's availability set (validates tile reachability)."""
        avail = tuple(sorted(ev.available))
        if not avail:
            # Let restrict() raise the canonical LostTileError with context.
            self.placement.restrict(avail)
        if ev.is_churn:
            self.churn_events += 1
        if avail != self._membership:
            self.placement.restrict(avail)   # raises LostTileError on data loss
            self._membership = avail

    # ------------------------------------------------------------------ #
    def _store_entry(self, avail: Tuple[int, ...], splan: StepPlan,
                     s_plan: np.ndarray) -> _CacheEntry:
        """Build a cache entry from a planned step: expand blocks, account
        rows (waste bookkeeping), stage the plan arrays on device, insert
        into the LRU cache. This is the whole per-plan host cost; once an
        entry exists, adopting it is an O(1) swap.

        Exception safety: every fallible operation completes BEFORE the
        cache insert below, which is the commit point."""
        from .executor import block_plan, device_plan

        bp = block_plan(
            splan.plan, self._staged.slot_of, self.cfg.block_rows,
            b_max=self.b_max,
        )
        rows = {n: splan.plan.rows_of(n) for n in range(self.placement.n_machines)}
        block_loads = (
            bp.n_blocks.astype(np.float64) * self.cfg.block_rows / self.rows_per_tile
        )
        # Plan arrays live on device with the cache entry: a cache hit (or a
        # no-straggler step) uploads nothing, so the measured step wall time
        # is executor time, not host->device transfer.
        dev = device_plan(bp, self.device)
        entry = _CacheEntry(
            step_plan=splan, block=bp, include0=bp.blk_include.copy(),
            rows=rows, s_plan=s_plan, block_loads=block_loads, dev=dev,
            stragglers=int(splan.plan.stragglers),
        )
        # ---- commit point: nothing below can raise on a built entry ----
        self._plan_cache[avail] = entry
        self._plan_cache.move_to_end(avail)
        self.plans_compiled += 1
        cap = self.cfg.plan_cache_size
        if cap is not None:
            while len(self._plan_cache) > max(int(cap), 1):
                # Evict least-recently-used, but never the live membership.
                for key in self._plan_cache:
                    if key != self._membership:
                        del self._plan_cache[key]
                        self.plans_evicted += 1
                        break
                else:  # pragma: no cover - cache holds only the live entry
                    break
        return entry

    def _plan_drift(self, entry: _CacheEntry, avail: Tuple[int, ...],
                    s_hat: np.ndarray) -> float:
        """Relative speed drift between the current estimates and the
        snapshot a memoized plan was built under. The assignment LP is
        scale-invariant, so only *relative* drift can make a plan stale —
        compare the mean-normalized vectors (the EWMA's absolute scale is
        tile-units per wall-second and moves a lot while the ratios stay
        put). Shared by :meth:`_plan_for` and :meth:`plan_is_ready` so the
        adoption gate and the window assembler's flush rule cannot
        diverge."""
        idx = np.asarray(avail, dtype=np.int64)
        a = s_hat[idx] / s_hat[idx].mean()
        b = entry.s_plan[idx] / entry.s_plan[idx].mean()
        return float(np.max(np.abs(a / b - 1.0)))

    def _plan_for(self, avail: Tuple[int, ...]) -> Tuple[_CacheEntry, bool]:
        """Memoized planning: returns (entry, cache_hit)."""
        master = self._master
        s_hat = master.speeds
        entry = self._plan_cache.get(avail)
        if entry is not None and entry.stragglers != master.stragglers:
            # A mid-run select_straggler_tolerance(commit=True) changed S:
            # a plan compiled under the old tolerance has the wrong segment
            # redundancy and must never be served again — evict, recompile.
            del self._plan_cache[avail]
            entry = None
        if entry is not None:
            self._plan_cache.move_to_end(avail)
            if master.homogeneous:
                # Homogeneous planning ignores the EWMA (all-ones speeds),
                # so estimator drift cannot stale a memoized plan — the
                # drift gate and its probe solve are pure overhead here.
                self.cache_hits += 1
                return entry, True
            drift = self._plan_drift(entry, avail, s_hat)
            if drift <= self.cfg.speed_tolerance:
                self.cache_hits += 1
                return entry, True
            # Drift past tolerance: price the re-plan before paying for it.
            # One cheap non-lexicographic solve gives the fresh optimum; if
            # the memoized plan is still within (1 + tol) of it, swapping
            # plans would move rows (transition waste) for almost no c*
            # gain — keep the plan and re-baseline its speed snapshot.
            # (This is what kept the device backend compiling one plan more
            # than the simulate backend on the same trace: estimator noise
            # alone forced a re-solve, and the near-identical fresh plan
            # still shuffled integerized rows.)
            # (The probe is a throwaway non-lexicographic solve: when the
            # gate does decide to re-plan, plan_step solves again with its
            # own lexicographic settings so every adopted plan is exactly
            # what on-demand planning would have produced. The duplicate
            # ~1ms solve only occurs on genuine-drift steps.)
            c_new = master.probe_c_star(avail)
            self.probe_solves += 1
            old_c = entry.step_plan.solution.time_of(master.plan_speeds)
            if old_c <= (1.0 + self.cfg.speed_tolerance) * c_new + 1e-12:
                entry.s_plan = s_hat
                self.cache_hits += 1
                return entry, True
        splan = master.plan_step(avail)
        entry = self._store_entry(avail, splan, s_hat)
        return entry, False

    def _adopt_plan(self) -> Tuple[_CacheEntry, bool, bool, int]:
        """Plan the current membership and account the transition. Returns
        ``(entry, cache_hit, replanned, waste)``: the ONE definition of
        plan adoption + transition-waste accounting (the fused window
        driver of a later slice shares it with :meth:`step`)."""
        prev = self._current
        entry, cache_hit = self._plan_for(self._membership)
        replanned = prev is None or entry is not prev
        waste = 0
        if replanned and prev is not None:
            preempted = [
                n for n in range(self.placement.n_machines)
                if n not in set(self._membership)
            ]
            waste = transition_waste(prev.rows, entry.rows, preempted)
            self.total_waste += waste
        self._current = entry
        return entry, cache_hit, replanned, waste

    def _precompile_neighbors(self, avail: Tuple[int, ...]) -> int:
        """Speculatively compile all single-preemption/arrival neighbors of
        ``avail`` in one batched solve+compile, so the next churn event hits
        the plan cache. Runs off the step critical path (after the step's
        result is already out); infeasible neighbors (a lost tile, or fewer
        than 1+S holders) are skipped. Returns the number of plans added."""
        N = self.placement.n_machines
        S = self._master.stragglers
        cur = set(avail)
        cand: List[Tuple[int, ...]] = [
            tuple(x for x in avail if x != n) for n in avail if len(avail) > 1
        ]
        cand += [
            tuple(sorted(cur | {n})) for n in range(N) if n not in cur
        ]
        todo = []
        for nb in cand:
            if nb in self._plan_cache or nb in todo:
                continue
            try:
                restricted = self.placement.restrict(nb)
            except LostTileError:
                continue
            if restricted.replication < 1 + S:
                continue
            todo.append(nb)
        cap = self.cfg.plan_cache_size
        if cap is not None:
            # Never speculate past the LRU budget: plans that would evict
            # existing entries (or each other) before they can be hit are
            # pure waste. Under memory pressure, speculation simply stops.
            budget = max(int(cap), 1) - len(self._plan_cache)
            if budget <= 0:
                return 0
            todo = todo[:budget]
        if not todo:
            return 0
        s_hat = self._master.speeds
        try:
            splans = self._master.plan_batch(todo)
        except Exception:
            # Speculation must never take down a live run: a neighbor whose
            # LP/filling hits a numerical edge is simply not cached (it will
            # be solved on demand — and raise there — only if actually
            # visited).
            return 0
        stored = 0
        for nb, splan in zip(todo, splans):
            try:
                self._store_entry(nb, splan, s_hat)
            except Exception:
                # Same contract as the batch solve above: a neighbor whose
                # block expansion or device upload fails is simply not
                # cached — the live step that triggered the speculation
                # must not die for it. _store_entry leaves nothing partial
                # behind (the cache insert is its commit point), so the
                # remaining neighbors still store cleanly.
                continue
            self.plans_precompiled += 1
            stored += 1
        return stored

    def _check_straggler_ids(self, stragglers: Sequence[int]) -> None:
        """Reject out-of-range straggler ids (a phantom id would otherwise
        be a silent no-op in ``include_mask``)."""
        N = self.placement.n_machines
        for s in stragglers:
            if not 0 <= int(s) < N:
                raise ValueError(
                    f"straggler id {int(s)} out of range: machine ids are "
                    f"0..{N - 1}")

    # ------------------------------------------------------------------ #
    # Unannounced-failure seams (repro_torch.faults). Faults are consulted
    # and consumed at each step's head; a fault the S budget cannot absorb
    # raises FaultAbort BEFORE any state-mutating dispatch, so the caller's
    # operand/carry stays valid and the step can re-execute after a replan.
    # ------------------------------------------------------------------ #
    def _consult_planning_faults(self, t: int) -> None:
        """Fire planning-path faults scheduled at absolute step ``t``:
        ``scheduler_kill`` tombstones the central master (the decentral
        replica keeps the run alive), ``stale_plan_table`` drops every
        replicated planning artifact. Both are consumed one-shot."""
        inj = self.fault_injector
        if inj is None:
            return
        from repro_torch.faults.chaos import PLANNING_KINDS

        for spec in inj.take(t, kinds=PLANNING_KINDS):
            if spec.kind == "scheduler_kill":
                if self.scheduler_killed:
                    inj.record(spec, "noop", "scheduler already dead")
                else:
                    self.kill_scheduler(
                        f"chaos: scheduler_kill before step {t}")
                    inj.record(
                        spec, "killed",
                        f"central master tombstoned before step {t}")
            else:  # stale_plan_table
                n_plans = len(self._plan_cache)
                n_table = self.invalidate_plan_state()
                detail = f"dropped {n_plans} cached plan(s)"
                if n_table:
                    detail += f" + {n_table} table entr(ies)"
                inj.record(spec, "invalidated", detail)

    def _take_dispatch_faults(self, t: int):
        """Consume the dispatch faults (crash / result drop) scheduled at
        absolute step ``t``; a target outside the membership is a recorded
        noop (it is already gone). Returns ``[(spec, worker), ...]``."""
        inj = self.fault_injector
        if inj is None:
            return []
        from repro_torch.faults.chaos import DISPATCH_KINDS

        out = []
        for spec in inj.take(t, kinds=DISPATCH_KINDS):
            n = int(spec.worker)
            if n not in self._membership:
                inj.record(spec, "noop",
                           f"worker {n} not in the membership")
                continue
            out.append((spec, n))
        return out

    def _coverable(self, entry: _CacheEntry, bad: Set[int]) -> bool:
        """Can this step proceed with every worker in ``bad`` silent? True
        when the plan's S budget covers the set (include_mask finds a
        surviving copy of every segment) AND at least one loaded worker
        remains to be consumed."""
        if not bad:
            return True
        if len(bad) > entry.stragglers:
            return False
        loaded = [n for n in self._membership
                  if entry.block.n_blocks[n] > 0]
        if len(set(loaded) - bad) < 1:
            return False
        try:
            entry.step_plan.plan.include_mask(tuple(sorted(bad)))
        except Exception:
            return False
        return True

    def _resolve_lost(
        self,
        t: int,
        entry: _CacheEntry,
        dfaults,
        injected: Optional[Tuple[int, ...]],
    ) -> Tuple[int, ...]:
        """Classify this step's dispatch faults against the S budget.

        Covered: the lost workers become realized stragglers — the fault
        is *masked* (and a crash queues its demotion for the caller).
        Not covered: record the demotions and raise :class:`FaultAbort`
        before anything dispatches — the caller demotes, replans, and
        re-executes this step. Returns the loaded lost set to mask."""
        from repro_torch.faults.chaos import FaultAbort

        inj = self.fault_injector
        loaded = {n for n in self._membership
                  if entry.block.n_blocks[n] > 0}
        lost = tuple(sorted({n for _, n in dfaults if n in loaded}))
        bad_all = set(injected or ()) | set(lost)
        if self._coverable(entry, bad_all):
            for spec, n in dfaults:
                if n not in loaded:
                    inj.record(spec, "noop",
                               f"worker {n} holds no rows this step")
                    continue
                inj.record(
                    spec, "masked",
                    f"step {t}: silent worker {n} covered by S="
                    f"{entry.stragglers}; realized straggler")
                if spec.kind == "worker_crash":
                    self.pending_demotions.add(n)
            return lost
        demote = tuple(sorted({n for _, n in dfaults}))
        for spec, n in dfaults:
            inj.record(
                spec, "demoted",
                f"step {t}: loss of worker {n} exceeds S="
                f"{entry.stragglers}; abort, demote, replan, re-execute")
        raise FaultAbort(
            t, dfaults[0][0].kind, lost=lost, demote=demote,
            detail=f"S={entry.stragglers} cannot cover {sorted(bad_all)}")

    def _take_speed_loss(self, t: int) -> bool:
        """Fire a scheduled ``speed_report_loss`` at absolute step ``t``:
        the step's measured durations never reach the master, so its EWMA
        feed is dropped by the caller. Output bits are already final.
        Returns True when a loss fired (one-shot)."""
        inj = self.fault_injector
        if inj is None:
            return False
        fired = False
        for spec in inj.take(t, kinds=("speed_report_loss",)):
            inj.record(
                spec, "report_dropped",
                f"step {t}: measured durations lost in transit; "
                f"EWMA update skipped")
            fired = True
        return fired

    def _timeout_check(
        self,
        t: int,
        entry: _CacheEntry,
        durations: Dict[int, float],
        already_bad: Set[int],
    ) -> Tuple[int, ...]:
        """Apply ``cfg.dispatch_timeout`` to modeled durations: workers
        past the deadline are silent as far as this step's master is
        concerned. Covered → returned (to mask as realized stragglers and
        censor from the EWMA). Not covered → FaultAbort with the timed-out
        set demoted (a worker this late is treated as dead)."""
        timeout = self.cfg.dispatch_timeout
        if timeout is None:
            return ()
        timed = tuple(sorted(
            n for n, d in durations.items()
            if d > timeout and n not in already_bad))
        if not timed:
            return ()
        if not self._coverable(entry, already_bad | set(timed)):
            from repro_torch.faults.chaos import FaultAbort

            raise FaultAbort(
                t, "dispatch_timeout", lost=timed, demote=timed,
                detail=f"worker(s) {list(timed)} exceeded "
                       f"dispatch_timeout={timeout} beyond the S budget")
        if self.fault_injector is not None:
            from repro_torch.faults.chaos import FaultSpec

            for n in timed:
                self.fault_injector.record(
                    FaultSpec("result_drop", max(t, 0), worker=n),
                    "masked",
                    f"step {t}: worker {n} past dispatch_timeout="
                    f"{timeout}; realized straggler",
                    detect_s=float(timeout))
        return timed

    def _derive_realized(
        self,
        durations: Dict[int, float],
        forced: Sequence[int] = (),
    ) -> Tuple[int, ...]:
        """Realized straggler set from modeled arrival order: the master
        consumes the first ``n_loaded - S`` completions, so the slowest S
        loaded workers (ties broken by id) are this step's stragglers. At
        least one worker is always consumed. ``forced`` pins workers whose
        results are already known lost (faults/timeouts) into the set —
        they spend budget first; only the remainder of S is derived from
        arrival order."""
        S = self._master.stragglers
        forced = tuple(sorted({int(n) for n in forced}))
        pool = sorted(set(durations) | set(forced))
        s_eff = min(S, max(len(pool) - 1, 0))
        extra = s_eff - len(forced)
        if extra <= 0:
            return forced
        rest = [n for n in sorted(durations) if n not in set(forced)]
        order = sorted(rest, key=lambda n: (durations[n], n))
        derived = order[len(order) - extra:]
        return tuple(sorted(set(forced) | {int(n) for n in derived}))

    def _winner_combine(
        self,
        parts: List[np.ndarray],
        loaded: List[int],
        entry: _CacheEntry,
        include: np.ndarray,
    ) -> np.ndarray:
        """Host-side first-arrival combine: gather each output row from its
        winning holder's partial. ``include`` (the ordinary refresh_include
        weights) marks exactly one surviving copy per segment, so every row
        has exactly one contributor — the gather returns the same bits the
        barrier combine would (the sum of the winner and zeros)."""
        bp = entry.block
        win = (include > 0) & (bp.blk_seg_t >= 0)
        n_idx, b_idx = np.nonzero(win)
        br = self.cfg.block_rows
        rows = (
            bp.blk_goff[n_idx, b_idx][:, None]
            + np.arange(br, dtype=np.int64)
        ).reshape(-1)
        winner = np.full(self.rows_total, -1, dtype=np.int64)
        winner[rows] = np.repeat(n_idx, br)
        if (winner < 0).any():  # pragma: no cover - plans cover every row
            missing = int(np.flatnonzero(winner < 0)[0])
            raise RuntimeError(
                f"no surviving holder delivered output row {missing}")
        pos = np.full(self.placement.n_machines, -1, dtype=np.int64)
        for i, n in enumerate(loaded):
            pos[n] = i
        stack = np.stack(parts)
        return stack[pos[winner], np.arange(self.rows_total)]

    # ------------------------------------------------------------------ #
    # Silent-corruption defense (cfg.verify_results)
    # ------------------------------------------------------------------ #
    def _verifying(self, t: int) -> bool:
        """Does ``verify_results`` check absolute step ``t``?"""
        if self._integrity is None:
            return False
        from repro_torch.faults.integrity import should_verify

        return should_verify(self.cfg.verify_results, t)

    def _mirror_tile(self, n: int, slot: int, src=None) -> None:
        """Write worker ``n``'s staged ``slot`` on the card: from the host
        copy, or (``src = (donor, donor_slot)``) device to device. In place:
        the fused window's CUDA graph holds the staged buffer by address,
        so the buffer is never re-bound (and never re-uploaded)."""
        import torch

        dst = self._staged_dev[n, slot]
        if src is None:
            dst.copy_(torch.from_numpy(self._staged.staged[n, slot]))
        else:
            dst.copy_(self._staged_dev[src[0], src[1]])

    def _card_sums(self) -> np.ndarray:
        """CRC32 of every tile of the card's staged buffer: one
        ``tile_checksum`` launch and one small device-to-host copy, outside
        any captured graph. (N, slots) int64."""
        from repro_torch.kernels.ops import tile_checksum

        return tile_checksum(self._staged_dev, 2).cpu().numpy()

    def _audit_sums(self) -> Optional[np.ndarray]:
        """The checksums a tile audit compares: the card's copy on the card
        (None on the host, where the checker runs zlib over the host copy,
        which is the staged tensor itself)."""
        return self._card_sums() if self.device.type == "cuda" else None

    def _consume_tile_corruption(self, t: int) -> None:
        """Fire scheduled ``tile_corruption`` faults: flip bits in the
        target's first stored replica tile (host copy, mirrored in place on
        the card). The fault is silent — detection is the fingerprint
        audit's job."""
        inj = self.fault_injector
        if inj is None:
            return
        from repro_torch.faults.integrity import corrupt_tile

        for spec in inj.take(t, kinds=("tile_corruption",)):
            n = int(spec.worker)
            stored = np.flatnonzero(self._staged.slot_of[n] >= 0)
            if n not in self._membership or stored.size == 0:
                inj.record(spec, "noop",
                           f"worker {n} stores no tiles")
                continue
            slot = int(self._staged.slot_of[n, int(stored[0])])
            corrupt_tile(self._staged.staged[n, slot])
            self._mirror_tile(n, slot)
            self._live_tile_specs[n] = spec

    def _audit_and_restage(self, t: int) -> None:
        """Pre-dispatch tile audit: re-checksum every staged replica of the
        copy the kernels read (the card's buffer by the ``tile_checksum``
        kernel; the host copy on the CPU) against its staging-time
        fingerprint. A corrupt tile is repaired IN PLACE from a surviving
        replica holder whose own copy still matches — on the host, and on
        the card as a device-to-device copy from the donor's slot. The plan
        (and therefore the output bits) is untouched and nobody is demoted.
        Only when no clean replica survives does the holder get demoted via
        :class:`FaultAbort`."""
        chk = self._integrity
        if chk is None or not chk.fingerprints:
            return
        sums = self._audit_sums()
        mismatches = chk.audit_tiles(self._staged.staged, sums=sums)
        if not mismatches:
            return
        from repro_torch.faults.chaos import FaultAbort, FaultSpec

        inj = self.fault_injector
        for n, slot, g in mismatches:
            spec = self._live_tile_specs.pop(n, None) or FaultSpec(
                "tile_corruption", max(t, 0), worker=n)
            donor = chk.find_donor(
                self._staged.staged, g, n, self._membership, sums=sums)
            if donor is None:
                if inj is not None:
                    inj.record(
                        spec, "demoted",
                        f"step {t}: tile {g} corrupt on worker {n} with "
                        f"no clean surviving replica; demote")
                raise FaultAbort(
                    t, "tile_corruption", lost=(n,), demote=(n,),
                    detail=f"tile {g} has no clean surviving replica")
            chk.restage(self._staged.staged, n, slot, g, donor)
            self._mirror_tile(
                n, slot, (donor, int(self._staged.slot_of[donor, g])))
            self.integrity["restaged"] += 1
            if inj is not None:
                inj.record(
                    spec, "restaged",
                    f"step {t}: tile {g} on worker {n} failed its "
                    f"staging fingerprint; re-staged from replica holder "
                    f"{donor} — capacity restored, plan untouched")

    def _graylist_forced(self, t: int, entry: _CacheEntry,
                         already: Set[int]) -> Set[int]:
        """Graylisted workers (repeat corruption offenders on probation)
        to force into this step's realized straggler set. Probation is
        best-effort: when the S budget cannot cover the distrusted
        worker, its (sketch-verified) result is consumed anyway."""
        chk = self._integrity
        if chk is None:
            return set()
        gray = chk.health.graylisted(t) & set(self._membership)
        gray -= set(already)
        if not gray or not self._coverable(entry, set(already) | gray):
            return set()
        return gray

    def _note_quarantine(self, t: int, workers: Set[int]) -> Set[int]:
        """Strike each corrupt worker's health ledger; returns the subset
        this strike newly graylisted."""
        gray = set()
        for n in sorted(workers):
            if self._integrity.health.strike(n, t):
                gray.add(n)
                self.integrity["graylist_events"] += 1
        return gray

    def _first_winner_row(self, entry: _CacheEntry, bad: Set[int],
                          n: int) -> Optional[int]:
        """First global output row worker ``n`` delivers under the
        current include weights (None when it wins no rows)."""
        from .executor import refresh_include

        include = refresh_include(
            entry.block, entry.step_plan.plan, tuple(sorted(bad)))
        win = (include[n] > 0) & (entry.block.blk_seg_t[n] >= 0)
        bs = np.nonzero(win)[0]
        if bs.size == 0:
            return None
        return int(entry.block.blk_goff[n, int(bs[0])])

    def _chunk_winners(self, entry: _CacheEntry, bad: Set[int],
                       chunks) -> Set[int]:
        """The workers that delivered the given ``block_rows`` row chunks
        under the current include weights — the localization step that
        turns a failed sketch into a named culprit."""
        from .executor import refresh_include

        include = refresh_include(
            entry.block, entry.step_plan.plan, tuple(sorted(bad)))
        bp = entry.block
        win = (include > 0) & (bp.blk_seg_t >= 0)
        n_idx, b_idx = np.nonzero(win)
        chunk_of = bp.blk_goff[n_idx, b_idx] // self.cfg.block_rows
        want = {int(c) for c in chunks}
        return {int(n) for n, c in zip(n_idx, chunk_of) if int(c) in want}

    def _record_result_spec(self, t: int, n: int, action: str,
                            detail: str) -> None:
        """Record the (injected or detected) result corruption of worker
        ``n`` at step ``t`` with ``action``."""
        from repro_torch.faults.chaos import FaultSpec

        spec = self._live_result_specs.pop(n, None) or FaultSpec(
            "result_corruption", max(t, 0), worker=n)
        if self.fault_injector is not None:
            self.fault_injector.record(spec, action, detail)

    def _integrity_first(
        self,
        t: int,
        entry: _CacheEntry,
        parts: List[np.ndarray],
        loaded: List[int],
        w,
        silent: Set[int],
        durations: Dict[int, float],
        injected,
    ) -> Tuple[Set[int], Dict[int, float]]:
        """First-arrival corruption seam: inject scheduled
        ``result_corruption`` into the fetched partials, then Freivalds-
        check each loaded worker's rows. A corrupt worker becomes a
        realized straggler — its rows are served by a surviving holder
        through the ordinary winner gather, its timing is censored from
        the EWMA — or, past the S budget, it is demoted via FaultAbort
        before the combine."""
        from repro_torch.faults.chaos import FaultAbort
        from repro_torch.faults.integrity import corrupt_result

        inj = self.fault_injector
        bp = entry.block
        if inj is not None:
            for spec in inj.take(t, kinds=("result_corruption",)):
                n = int(spec.worker)
                if n not in loaded:
                    inj.record(spec, "noop",
                               f"worker {n} has no partial this step")
                    continue
                # A host view of a device-run output may alias the
                # executor's tensor: corrupt a copy.
                i = loaded.index(n)
                p = np.array(parts[i])
                corrupt_result(p, int(bp.blk_goff[n, 0]))
                parts[i] = p
                self._live_result_specs[n] = spec
        chk = self._integrity
        if chk is None or not chk.linear or not self._verifying(t):
            return silent, durations
        br = self.cfg.block_rows
        corrupt: Set[int] = set()
        for i, n in enumerate(loaded):
            nb = int(bp.n_blocks[n])
            chunks = (bp.blk_goff[n, :nb] // br).tolist()
            if not chk.check_chunks(t, parts[i], w, chunks):
                corrupt.add(n)
        if not corrupt:
            return silent, durations
        newly_gray = self._note_quarantine(t, corrupt)
        lost = tuple(sorted(corrupt))
        if not self._coverable(
                entry, silent | corrupt | set(injected or ())):
            for n in lost:
                self._record_result_spec(
                    t, n, "demoted",
                    f"step {t}: corrupt partial from worker {n} "
                    f"exceeds S={entry.stragglers}; abort, demote, "
                    f"replan, re-execute")
            raise FaultAbort(
                t, "result_corruption", lost=lost, demote=lost,
                detail=f"S={entry.stragglers} cannot cover corrupt "
                       f"worker(s) {list(lost)}")
        self.integrity["quarantined"] += len(corrupt)
        for n in lost:
            self._record_result_spec(
                t, n, "quarantined",
                f"step {t}: worker {n}'s partial failed the "
                f"Freivalds sketch; realized straggler, rows served "
                f"by a surviving holder, timing censored"
                + (", graylisted" if n in newly_gray else ""))
        return silent | corrupt, {
            n: d for n, d in durations.items() if n not in corrupt}

    def _integrity_barrier(
        self,
        t: int,
        entry: _CacheEntry,
        y: np.ndarray,
        w,
        bad: Tuple[int, ...],
        durations: Dict[int, float],
    ) -> Tuple[np.ndarray, Dict[int, float], Tuple[int, ...]]:
        """Barrier corruption seam: inject scheduled
        ``result_corruption`` into the fetched output, Freivalds-check
        it, and on failure localize the corrupt row chunks to their
        producing worker. Recovery mirrors the covered-timeout template:
        the SAME executor re-dispatches with the culprit's copies masked
        out of the include weights (bit-identical output, nothing
        rebuilt); past the S budget the culprit is demoted via
        FaultAbort. Returns ``(y, durations, bad)``."""
        from repro_torch.faults.chaos import FaultAbort
        from repro_torch.faults.integrity import corrupt_result

        inj = self.fault_injector
        bad_set = set(bad)
        if inj is not None:
            for spec in inj.take(t, kinds=("result_corruption",)):
                n = int(spec.worker)
                row = (self._first_winner_row(entry, bad_set, n)
                       if n in self._membership else None)
                if row is None:
                    inj.record(spec, "noop",
                               f"worker {n} delivers no output rows "
                               f"this step")
                    continue
                # The fetched output may alias the executor's tensor.
                y = np.array(y)
                corrupt_result(y, row)
                self._live_result_specs[n] = spec
        chk = self._integrity
        if chk is None or not chk.linear or not self._verifying(t) \
                or chk.check_output(t, y, w):
            return y, durations, tuple(sorted(bad_set))
        bad_chunks = chk.locate(t, y, w)
        culprits = self._chunk_winners(entry, bad_set, bad_chunks)
        culprits -= bad_set
        if not culprits:
            # Defensive: a tripped sketch with no attributable producer.
            # Abort with nothing demoted — the engine's recovery loop
            # re-executes the step (the injection, being one-shot, is
            # already consumed).
            raise FaultAbort(
                t, "result_corruption", lost=(), demote=(),
                detail="sketch failure with no attributable producer")
        newly_gray = self._note_quarantine(t, culprits)
        lost = tuple(sorted(culprits))
        bad_new = tuple(sorted(bad_set | culprits))
        if not self._coverable(entry, set(bad_new)):
            for n in lost:
                self._record_result_spec(
                    t, n, "demoted",
                    f"step {t}: corrupt output rows from worker {n} "
                    f"exceed S={entry.stragglers}; abort, demote, "
                    f"replan, re-execute")
            raise FaultAbort(
                t, "result_corruption", lost=lost, demote=lost,
                detail=f"S={entry.stragglers} cannot cover corrupt "
                       f"worker(s) {list(lost)}")
        y, _ = self._barrier_dispatch(entry, w, bad_new)
        durations = {n: d for n, d in durations.items()
                     if n not in culprits}
        self.integrity["quarantined"] += len(culprits)
        for n in lost:
            self._record_result_spec(
                t, n, "quarantined",
                f"step {t}: worker {n}'s output rows failed the "
                f"Freivalds sketch; masked and re-dispatched without "
                f"it, timing censored"
                + (", graylisted" if n in newly_gray else ""))
        if not chk.check_output(t, y, w):  # pragma: no cover - belt
            raise FaultAbort(
                t, "result_corruption", lost=lost, demote=lost,
                detail="re-dispatched output still fails the sketch")
        return y, durations, bad_new

    def _integrity_window(
        self,
        base: int,
        n_active: int,
        metas,
        sets,
        ys: np.ndarray,
        ws: np.ndarray,
        ws_d,
    ) -> List[Set[int]]:
        """Fused-window corruption seam (post-fetch): inject scheduled
        ``result_corruption`` into each active step's fetched output
        (a host copy), Freivalds-check each step, and repair corrupt row
        chunks by recomputing them from a surviving replica holder's
        staged tile (:meth:`_replica_recompute`; ``ws_d`` is the window's
        operands on the device) — the realized include is baked into the
        already-replayed window, and a stepwise re-dispatch would leave
        the one-program contract. The
        device carry was computed from the device partials, which the
        host-side corruption never touched, so later windows stay clean.
        Returns the per-step quarantined sets (censored from the EWMA)."""
        from repro_torch.faults.chaos import FaultAbort
        from repro_torch.faults.integrity import corrupt_result

        inj = self.fault_injector
        chk = self._integrity
        out: List[Set[int]] = [set() for _ in range(n_active)]
        for k in range(n_active):
            tk = base + k
            entry = metas[k][1]
            rspecs = metas[k][8]
            bad_set = set(sets[k])
            for spec in rspecs:
                n = int(spec.worker)
                row = (self._first_winner_row(entry, bad_set, n)
                       if n in metas[k][0] else None)
                if row is None:
                    if inj is not None:
                        inj.record(spec, "noop",
                                   f"worker {n} delivers no output rows "
                                   f"this step")
                    continue
                corrupt_result(ys[k], row)
                self._live_result_specs[n] = spec
            if chk is None or not chk.linear or not self._verifying(tk):
                continue
            if chk.check_output(tk, ys[k], ws[k]):
                continue
            bad_chunks = chk.locate(tk, ys[k], ws[k])
            culprits = self._chunk_winners(entry, bad_set, bad_chunks)
            culprits -= bad_set
            if not culprits:  # pragma: no cover - defensive
                raise FaultAbort(
                    tk, "result_corruption", lost=(), demote=(),
                    detail="sketch failure with no attributable producer")
            newly_gray = self._note_quarantine(tk, culprits)
            alive = set(metas[k][0]) - culprits
            for c in bad_chunks:
                owners = self._chunk_winners(entry, bad_set, [c])
                owner = sorted(owners)[0] if owners else -1
                g = (c * self.cfg.block_rows) // self.rows_per_tile
                donor = chk.find_donor(
                    self._staged.staged, g, owner, alive,
                    sums=self._audit_sums())
                if donor is None:
                    lost = tuple(sorted(culprits))
                    raise FaultAbort(
                        tk, "result_corruption", lost=lost, demote=lost,
                        detail=f"no clean replica holder covers tile {g}")
                fixed = self._replica_recompute(donor, c, ws[k], ws_d[k])
                ys[k][chk.chunk_rows(c)] = fixed.astype(ys.dtype)
                self.integrity["repaired_rows"] += self.cfg.block_rows
            self.integrity["quarantined"] += len(culprits)
            for n in sorted(culprits):
                self._record_result_spec(
                    tk, n, "quarantined",
                    f"step {tk}: worker {n}'s rows failed the "
                    f"Freivalds sketch inside a fused window; "
                    f"recomputed from a replica holder's tile, "
                    f"timing censored"
                    + (", graylisted" if n in newly_gray else ""))
            out[k] |= culprits
            if not chk.check_output(tk, ys[k], ws[k]):  # pragma: no cover
                raise RuntimeError(
                    f"step {tk}: repaired window output still fails the "
                    f"integrity sketch")
        return out

    def _replica_recompute(self, donor: int, chunk: int, w,
                           w_dev) -> np.ndarray:
        """One ``block_rows`` row chunk recomputed from ``donor``'s
        staged replica tile. On the card: one call of the workload's block
        kernel (``usec_matvec``) on the card's copy of the tile — the bits
        the kernels read — with the operand ``w_dev`` already there, so
        the result is the kernel's own. On the host: the checker's float64
        recompute over the host copy, as the reference. The two agree bit
        for bit on the integer grid."""
        if self.device.type != "cuda":
            return self._integrity.replica_recompute(
                self._staged.staged, donor, chunk, w, self.rows_per_tile)
        start = chunk * self.cfg.block_rows
        g = start // self.rows_per_tile
        off = start - g * self.rows_per_tile
        slot = int(self._staged.slot_of[donor, g])
        xb = self._staged_dev[donor, slot, off:off + self.cfg.block_rows]
        return self._matmul(xb, w_dev).cpu().numpy()

    # ------------------------------------------------------------------ #
    def _sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _dispatch_workers(self, entry: _CacheEntry, loaded: List[int],
                          w_dev) -> List:
        """Launch every loaded worker's unmasked partial and wait for all of
        them. On the card each worker runs on its own stream and records its
        own event; the host waits on each event. Returns the partials (on
        the device)."""
        import torch

        dev = entry.dev
        if self.device.type != "cuda":
            return [self._worker_exec(self._staged_dev, n, dev, w_dev,
                                      dev.valid[n]) for n in loaded]
        if self._worker_streams is None:
            self._worker_streams = [
                torch.cuda.Stream(device=self.device)
                for _ in range(self.placement.n_machines)]
        cur = torch.cuda.current_stream(self.device)
        parts, events = [], []
        for n in loaded:
            s = self._worker_streams[n]
            s.wait_stream(cur)   # the operand's upload is on `cur`
            with torch.cuda.stream(s):
                # Allocated on `s`: the caching allocator keeps the partial
                # and its temporaries until `s` is done with them.
                parts.append(self._worker_exec(
                    self._staged_dev, n, dev, w_dev, dev.valid[n]))
                ev = torch.cuda.Event()
                ev.record(s)
            w_dev.record_stream(s)
            events.append(ev)
        for ev in events:
            ev.synchronize()
        return parts

    def _step_first(
        self,
        w: np.ndarray,
        entry: _CacheEntry,
        cache_hit: bool,
        replanned: bool,
        waste: int,
        t0: float,
        injected: Optional[Tuple[int, ...]],
        lost: Tuple[int, ...] = (),
    ) -> Tuple[np.ndarray, StepReport]:
        """First-arrival step: per-worker dispatch, consume-first combine.

        Every loaded worker's partial is dispatched on its own (unmasked —
        arrival order is not known yet). The clock then models arrival
        order; the slowest S loaded workers become the realized straggler
        set (unless ``injected`` pins one), the ordinary include weights
        mask their copies out, and the output gathers each row from its
        winning holder. Late workers are measurements, not losses: every
        loaded duration feeds the EWMA. Modeled completion is the
        (n_loaded - S)-th order statistic — the barrier's max only at S=0.

        ``lost`` (pre-classified, covered dispatch faults) are workers
        whose partial never arrives: they are not dispatched, spend the S
        budget first in the realized set, and are censored from the EWMA.
        """
        import torch

        from .executor import refresh_include

        t = self._step
        replan_s = time.perf_counter() - t0
        silent = set(lost)
        loaded = [n for n in self._membership
                  if entry.block.n_blocks[n] > 0 and n not in silent]
        w_dev = torch.as_tensor(w).to(self.device)
        self._sync()
        t1 = time.perf_counter()
        parts_d = self._dispatch_workers(entry, loaded, w_dev)
        wall = time.perf_counter() - t1
        self._drivers_run.add("worker")
        self.device_dispatches += len(parts_d)
        self._last_step_wall = wall
        parts = [p.cpu().numpy() for p in parts_d]

        row_loads = entry.block_loads * self.rows_per_tile
        # The clock still models EVERY loaded worker (the lost one was
        # assigned its rows and the speed process keeps its cadence);
        # censoring happens after the draw — the measurement never arrives.
        durations = self.clock.durations(row_loads, self._membership, wall)
        for n in silent:
            durations.pop(n, None)
        timed = self._timeout_check(
            t, entry, durations, silent | set(injected or ()))
        if timed:
            silent |= set(timed)
            for n in timed:
                durations.pop(n, None)
        silent, durations = self._integrity_first(
            t, entry, parts, loaded, w, silent, durations, injected)
        forced = tuple(sorted(silent))
        if injected is None:
            realized = self._derive_realized(durations, forced=forced)
        else:
            realized = tuple(sorted(set(injected) | silent))
        # Host-side feasibility + winner weights: include_mask raises when a
        # segment lost every holder, exactly like the barrier path.
        include = refresh_include(entry.block, entry.step_plan.plan, realized)
        y = self._winner_combine(parts, loaded, entry, include)

        self._pending_loads = {
            n: float(entry.block_loads[n]) for n in durations
        }
        self._pending_durations = durations
        if self._take_speed_loss(t):
            self._pending_loads, self._pending_durations = {}, {}
        skipped = set(realized)
        consumed = [d for n, d in durations.items() if n not in skipped]
        modeled = max(consumed) if consumed else 0.0

        if self.cfg.verify:
            self._verify(y, w)

        self._step += 1
        report = StepReport(
            step=self._step,
            available=self._membership,
            replanned=replanned,
            plan_cache_hit=cache_hit,
            replan_s=replan_s,
            wall_s=wall,
            modeled_completion=modeled,
            straggled=realized,
            waste=waste,
            jit_cache_size=self.executor_cache_size,
            measured=durations,
            speeds_hat=entry.s_plan,
        )
        if self.cfg.precompile_neighbors and not cache_hit:
            t2 = time.perf_counter()
            self._precompile_neighbors(self._membership)
            self.precompile_s += time.perf_counter() - t2
        self._notify_completion([report])
        return y, report

    def step(
        self,
        w: np.ndarray,
        event: Optional[ElasticEvent] = None,
        stragglers: Optional[Sequence[int]] = None,
    ) -> Tuple[np.ndarray, StepReport]:
        """Execute one elastic step ``y = X @ w`` under the current plan.

        ``event`` (if any) is applied before planning. ``stragglers=None``
        means "no injection": under ``arrival="barrier"`` no copies are
        masked, under ``arrival="first"`` the realized straggler set is
        derived from modeled arrival order. An explicit sequence (possibly
        empty) *injects* that set in either mode — masked copies are
        dropped from the combine (include weights), exactly one surviving
        holder per segment delivers. Raises ``ValueError`` on an
        out-of-range id and errors out if the set exceeds the plan's
        tolerance. Returns ``y`` as host NumPy.

        With a :attr:`fault_injector` installed, faults scheduled at this
        step fire here: planning faults before the EWMA ingest, tile
        corruption (and, on verified steps, the audit and re-staging)
        before anything dispatches, dispatch faults (crash / result drop)
        classified against the S budget — covered losses are masked as
        realized stragglers (censored from the EWMA), uncovered losses
        raise :class:`~repro_torch.faults.chaos.FaultAbort` before anything
        dispatches — and result corruption after the fetch.
        """
        if event is not None:
            self.apply_event(event)
        t = self._step
        self._consult_planning_faults(t)
        # Tile corruption fires (and is audited + re-staged) BEFORE the
        # dispatch reads the staged bits, uniform across arrival modes.
        self._consume_tile_corruption(t)
        if self._verifying(t):
            self._audit_and_restage(t)
        t0 = time.perf_counter()
        # Feed last step's measured durations into the EWMA (Alg. 1 line 4)
        # BEFORE planning, so the plan sees the freshest estimates.
        self.ingest_pending()
        injected: Optional[Tuple[int, ...]] = None
        if stragglers is not None:
            injected = tuple(sorted({int(s) for s in stragglers}))
            self._check_straggler_ids(injected)
        lost: Tuple[int, ...] = ()
        dfaults = self._take_dispatch_faults(t)
        if dfaults:
            # Peek the plan BEFORE adoption: an uncovered fault must abort
            # with the plan/waste accounting untouched, so the re-executed
            # step replans cleanly after the caller's demotion event.
            peek, _ = self._plan_for(self._membership)
            lost = self._resolve_lost(t, peek, dfaults, injected)
        entry, cache_hit, replanned, waste = self._adopt_plan()
        gray = self._graylist_forced(
            t, entry, set(injected or ()) | set(lost))
        if gray:
            # Probation: a graylisted worker is a forced realized
            # straggler — excluded from the combine and the EWMA, plan
            # (and bits) untouched.
            lost = tuple(sorted(set(lost) | gray))
        if self.cfg.arrival == "first":
            return self._step_first(
                w, entry, cache_hit, replanned, waste, t0, injected, lost)
        bad = tuple(sorted(set(injected or ()) | set(lost)))
        replan_s = time.perf_counter() - t0

        y, wall = self._barrier_dispatch(entry, w, bad)
        self._last_step_wall = wall

        row_loads = entry.block_loads * self.rows_per_tile
        durations = self.clock.durations(row_loads, self._membership, wall)
        if lost:
            # A silent worker's duration is censored — its result never
            # arrived, so there is no measurement to feed the EWMA.
            durations = {n: d for n, d in durations.items()
                         if n not in set(lost)}
        timed = self._timeout_check(t, entry, durations, set(bad))
        if timed:
            # Covered timeout: the barrier master gave up on the late
            # workers and re-collected from the survivors — one recovery
            # re-dispatch with the refreshed include weights (same bits:
            # exactly one surviving copy of every segment delivers).
            bad = tuple(sorted(set(bad) | set(timed)))
            y, wall_b = self._barrier_dispatch(entry, w, bad)
            wall += wall_b
            durations = {n: d for n, d in durations.items()
                         if n not in set(timed)}
        # The quarantine's masked re-dispatch is recovery, not the step:
        # it stays out of wall_s, as in the reference.
        y, durations, bad = self._integrity_barrier(
            t, entry, y, w, bad, durations)
        # The EWMA is fed tile-unit loads (the LP's unit), so estimated
        # speeds stay consistent with the planner; clocks see row units.
        self._pending_loads = {
            n: float(entry.block_loads[n]) for n in durations
        }
        self._pending_durations = durations
        if self._take_speed_loss(t):
            self._pending_loads, self._pending_durations = {}, {}
        modeled = max(durations.values()) if durations else 0.0

        if self.cfg.verify:
            self._verify(y, w)

        self._step += 1
        report = StepReport(
            step=self._step,
            available=self._membership,
            replanned=replanned,
            plan_cache_hit=cache_hit,
            replan_s=replan_s,
            wall_s=wall,
            modeled_completion=modeled,
            straggled=bad,
            waste=waste,
            jit_cache_size=self.executor_cache_size,
            measured=durations,
            speeds_hat=entry.s_plan,
        )
        if self.cfg.precompile_neighbors and not cache_hit:
            # The step's result is already computed — spend the idle tail
            # batch-compiling the churn neighborhood of the new membership
            # so the NEXT membership change is a cache hit.
            t2 = time.perf_counter()
            self._precompile_neighbors(self._membership)
            self.precompile_s += time.perf_counter() - t2
        self._notify_completion([report])
        return y, report

    def _barrier_dispatch(self, entry: _CacheEntry, w,
                          bad: Tuple[int, ...]) -> Tuple[np.ndarray, float]:
        """One barrier executor call with ``bad``'s copies masked out of
        the include weights (the plan's own weights when ``bad`` is
        empty). Returns ``(y, wall)``: the output on the host, and the
        synchronized wall of the call."""
        import torch

        from .executor import refresh_include

        include_d = None if not bad else torch.as_tensor(
            refresh_include(entry.block, entry.step_plan.plan, bad),
            device=self.device)
        w_dev = torch.as_tensor(w)
        self._sync()
        t1 = time.perf_counter()
        y = self._executor(
            self._staged_dev, entry.dev, w_dev.to(self.device), include_d)
        self._sync()
        wall = time.perf_counter() - t1
        self._drivers_run.add("step")
        self.device_dispatches += 1
        return y.cpu().numpy(), wall

    def ingest_pending(self) -> None:
        """Fold any pending measured durations into the EWMA (Algorithm 1
        line 4). Idempotent; :meth:`step` does this at its top."""
        if not self._pending_durations:
            return
        self._master.report(self._pending_loads, self._pending_durations)
        self._measured_ever.update(int(n) for n in self._pending_durations)
        if not self._speed_seeded and self._measured_ever:
            est = self._master.estimator
            s = est.speeds
            known = sorted(self._measured_ever)
            anchor = float(np.exp(np.mean(np.log(s[known]))))
            for n in range(self.placement.n_machines):
                if n not in self._measured_ever:
                    est.set_speed(n, anchor)
        self._pending_loads, self._pending_durations = {}, {}

    def plan_is_ready(self, avail: Sequence[int]) -> bool:
        """True when adopting ``avail`` would be a plan-cache HIT (no solve
        on the step path). The engine's window assembler uses this as the
        flush rule: churn onto a ready membership is in-window data; churn
        onto a miss flushes the window so the assembled steps dispatch
        immediately instead of queueing behind a multi-ms solve. Mirrors
        :meth:`_plan_for` exactly, including the c*-pricing fallback past
        the drift tolerance. No scheduler/cache state is touched."""
        master = self._master
        key = tuple(sorted(int(a) for a in avail))
        entry = self._plan_cache.get(key)
        if entry is None:
            return False
        if entry.stragglers != master.stragglers:
            # Stale tolerance (see _plan_for): adopting would recompile.
            return False
        if master.homogeneous:
            # Membership-only planning: drift cannot stale the entry.
            return True
        s_hat = master.speeds
        if self._plan_drift(entry, key, s_hat) <= self.cfg.speed_tolerance:
            return True
        c_new = master.probe_c_star(key)
        self.probe_solves += 1
        old_c = entry.step_plan.solution.time_of(master.plan_speeds)
        return bool(
            old_c <= (1.0 + self.cfg.speed_tolerance) * c_new + 1e-12)

    def step_window(
        self,
        w,
        straggler_sets: Sequence[Optional[Sequence[int]]] = ((),),
        events: Optional[Sequence[Optional[ElasticEvent]]] = None,
    ):
        """Execute up to ``fuse_steps`` steps in ONE device dispatch.

        A ``None`` entry in ``straggler_sets`` means "no injection" for that
        step — under ``arrival="first"`` its realized straggler set is
        derived from modeled arrival order at assembly time (and masked on
        the card through the include gather); under ``arrival="barrier"``
        it is an empty set. Explicit sequences inject, as in :meth:`step`.

        Each active step carries its OWN event, straggler set and (cached)
        plan, so churn inside the window is data; the engine flushes early
        (``len(sets) < K``) only when a step's membership is a plan-cache
        miss. The dispatched window is ALWAYS K steps (inactive tail steps
        have zeroed trip counts and weights and their outputs are
        discarded), so the segmented mode's window graph is captured once
        for the whole run.

        ``w`` is the iterate carry: a NumPy array on the first window, the
        device tensor returned by the previous window afterwards (valid
        until the next window). Returns ``(w_carry, ys, ws, reports)``: the
        next carry (device), the per-active-step raw outputs and consumed
        operands (NumPy — one fetch for the whole window), and one
        :class:`StepReport` per active step.

        Speed measurements are ingested ONCE per window (window wall /
        active steps per step, in tile-units/s), so the EWMA and its
        c*-priced drift gate keep working at any ``fuse_steps``; while the
        card runs the window, the host overlaps the speculative neighbor
        precompile of the newest membership.
        """
        import torch

        if self._fused is None:
            raise RuntimeError(
                "step_window needs fuse_steps > 1 and a fusable workload "
                "(workload.fused_update returned None)")
        K = self.cfg.fuse_steps
        sets = [
            None if bad is None else tuple(sorted({int(s) for s in bad}))
            for bad in straggler_sets
        ]
        n_active = len(sets)
        if not 1 <= n_active <= K:
            raise ValueError(
                f"window wants {n_active} active steps, fuse_steps={K}")
        if events is None:
            events = [None] * n_active
        if len(events) != n_active:
            raise ValueError("events and straggler_sets must align per step")
        # Feed last window's measured durations into the EWMA before any of
        # this window's planning (idempotent: the engine already did this
        # before assembling the window).
        self.ingest_pending()

        N = self.placement.n_machines
        bad = np.zeros((K, N), dtype=bool)
        metas = []
        had_miss = False
        base = self._step
        for k in range(n_active):
            t0 = time.perf_counter()
            tk = base + k
            if events[k] is not None:
                self.apply_event(events[k])
            # Fault seams fire at assembly time, per step: nothing has
            # dispatched yet, so an uncovered loss aborts the WHOLE window
            # cleanly (FaultAbort) with the carry untouched — the engine
            # demotes, replans, and re-assembles from this window's head.
            self._consult_planning_faults(tk)
            # Tile corruption fires (and is audited + re-staged in place)
            # at assembly, BEFORE the window replays: the engine breaks
            # windows at fault steps, so a corrupt tile always lands at a
            # window head.
            self._consume_tile_corruption(tk)
            if self._verifying(tk):
                self._audit_and_restage(tk)
            dfaults = self._take_dispatch_faults(tk)
            # Result corruption is consumed at assembly but applied (and
            # detected) post-fetch — the injection perturbs the fetched
            # host copy, as a corrupt wire transfer would.
            rspecs = (
                () if self.fault_injector is None
                else tuple(self.fault_injector.take(
                    tk, kinds=("result_corruption",)))
            )
            forced: Tuple[int, ...] = ()
            if dfaults:
                peek, _ = self._plan_for(self._membership)
                forced = self._resolve_lost(tk, peek, dfaults, sets[k])
            entry, cache_hit, replanned, waste = self._adopt_plan()
            gray = self._graylist_forced(
                tk, entry, set(forced) | set(sets[k] or ()))
            if gray:
                forced = tuple(sorted(set(forced) | gray))
            had_miss = had_miss or not cache_hit
            durs_k = None
            if sets[k] is None:
                if self.cfg.arrival == "first":
                    # Derive this step's realized stragglers at assembly
                    # time: the on-card include gather needs the bitmask
                    # before dispatch, so the clock is sampled here (once
                    # per step, in step order, the stepwise cadence)
                    # against the previous dispatch's per-step wall.
                    # Silent workers are drawn (cadence), then censored.
                    row_loads = entry.block_loads * self.rows_per_tile
                    durs_k = self.clock.durations(
                        row_loads, self._membership, self._last_step_wall)
                    for n in forced:
                        durs_k.pop(n, None)
                    timed = self._timeout_check(
                        tk, entry, durs_k, set(forced))
                    if timed:
                        forced = tuple(sorted(set(forced) | set(timed)))
                        for n in timed:
                            durs_k.pop(n, None)
                    sets[k] = self._derive_realized(durs_k, forced=forced)
                else:
                    sets[k] = tuple(forced)
            else:
                self._check_straggler_ids(sets[k])
                if forced:
                    sets[k] = tuple(sorted(set(sets[k]) | set(forced)))
            if sets[k]:
                # Host-side feasibility check (the device gather cannot
                # raise): include_mask errors out when a segment lost every
                # holder, exactly like the stepwise path.
                entry.step_plan.plan.include_mask(sets[k])
                bad[k, list(sets[k])] = True
            metas.append((self._membership, entry, replanned, cache_hit,
                          time.perf_counter() - t0, waste, durs_k, forced,
                          rspecs))
        # Pad inactive tail slots with the last entry's plan (masked out on
        # the card) so the window's shapes never change.
        plans = [m[1].dev for m in metas]
        plans += [plans[-1]] * (K - n_active)
        active = np.zeros((K,), dtype=bool)
        active[:n_active] = True

        w_dev = (w if torch.is_tensor(w)
                 else torch.as_tensor(np.asarray(w)).to(self.device))
        self._sync()
        t1 = time.perf_counter()
        w_carry, ys_d, ws_d = self._fused(
            self._staged_dev, plans, bad, active, w_dev)
        self.device_dispatches += 1
        # Overlap: the dispatch is asynchronous on the card — spend the
        # device time on the churn neighborhood's speculative compile.
        pre_s = 0.0
        if self.cfg.precompile_neighbors and had_miss:
            t2 = time.perf_counter()
            self._precompile_neighbors(self._membership)
            pre_s = time.perf_counter() - t2
            self.precompile_s += pre_s
        self._sync()
        # wall_s means "executor time"; a host-run precompile would bill
        # planning to the clock, so subtract it (on the card, genuine
        # overlap makes this an under- rather than over-estimate).
        wall = max(time.perf_counter() - t1 - pre_s, 1e-9)
        ys = ys_d.cpu().numpy()[:n_active]
        ws = ws_d.cpu().numpy()[:n_active]
        if self._integrity is not None or self.fault_injector is not None:
            # The integrity seam injects / repairs rows in place; on the
            # host the fetched array is a view of the window's output, so
            # give it a copy of its own.
            ys = np.array(ys)
        quarantined = self._integrity_window(
            base, n_active, metas, sets, ys, ws, ws_d)

        # Per-window per-worker times: the window wall divided over its
        # active steps is the per-step equivalent the EWMA expects. Loads and
        # durations accumulate over the window's per-step plans and are
        # reported as ONE measurement at the next window.
        per_step_wall = wall / n_active
        self._last_step_wall = per_step_wall
        loads_sum: Dict[int, float] = {}
        dur_sum: Dict[int, float] = {}
        per_step_durs = []
        for k in range(n_active):
            entry = metas[k][1]
            durs = metas[k][6]
            if durs is None:
                row_loads = entry.block_loads * self.rows_per_tile
                durs = self.clock.durations(
                    row_loads, metas[k][0], per_step_wall)
                for n in metas[k][7]:
                    # Censor silent workers (covered faults): their result
                    # — and therefore their measurement — never arrived.
                    durs.pop(n, None)
            for n in quarantined[k]:
                # Censor quarantined workers: a corrupt result's timing
                # is as untrustworthy as its payload.
                durs.pop(n, None)
            per_step_durs.append(durs)
            if self._take_speed_loss(base + k):
                # This step's report was lost in transit: its durations
                # stay out of the window's accumulated EWMA feed.
                continue
            for n, d in durs.items():
                loads_sum[n] = loads_sum.get(n, 0.0) \
                    + float(entry.block_loads[n])
                dur_sum[n] = dur_sum.get(n, 0.0) + d
        self._pending_loads = loads_sum
        self._pending_durations = dur_sum

        if self.cfg.verify:
            for k in range(n_active):
                self._verify(ys[k], ws[k])

        reports = []
        for k, (avail, entry, replanned, cache_hit, replan_s, waste, _d,
                _f, _r) in enumerate(metas):
            self._step += 1
            durs = per_step_durs[k]
            if self.cfg.arrival == "first":
                # First-arrival completion: the master stops at the last
                # CONSUMED worker; realized stragglers are not waited on.
                skipped = set(sets[k])
                consumed = [d for n, d in durs.items() if n not in skipped]
            else:
                consumed = list(durs.values())
            reports.append(StepReport(
                step=self._step,
                available=avail,
                replanned=replanned,
                plan_cache_hit=cache_hit,
                replan_s=replan_s,
                wall_s=per_step_wall,
                modeled_completion=max(consumed) if consumed else 0.0,
                straggled=sets[k],
                waste=waste,
                jit_cache_size=self.executor_cache_size,
                measured=durs,
                speeds_hat=entry.s_plan,
            ))
        self._notify_completion(reports)
        return w_carry, ys, ws, reports

    def _verify(self, y: np.ndarray, w: np.ndarray) -> None:
        # The reference is the workload's business: X @ w for matvec,
        # X @ W for matmat, the NumPy row map for map-reduce.
        self.workload.verify(y, w, self._x64, mode=self.cfg.verify,
                             atol=self.cfg.allclose_atol)


# ---------------------------------------------------------------------- #
# Power-iteration helpers (shared by the workload and the smoke run)
# ---------------------------------------------------------------------- #
def _tree_sumsq(v, xp):
    """Sum of squares by an explicit binary tree of elementwise adds.

    ``xp`` is the array module: numpy on the host, torch for the fused
    window's on-device update. Library reductions choose their own
    accumulation order, so a host value and a device twin can disagree in
    the last ulp. This reduction pins the order: square, zero-pad to a power
    of two, halve by adding strided slices. Every step is an elementwise
    IEEE op, so any backend that follows the schedule produces the SAME bits
    as the reference package's :func:`quantize_unit`.
    """
    s = v * v
    n = 1
    while n < s.shape[0]:
        n *= 2
    if n != s.shape[0]:
        pad = (xp.zeros(n - s.shape[0], s.dtype) if xp is np
               else s.new_zeros(n - s.shape[0]))
        s = xp.concatenate([s, pad])
    while s.shape[0] > 1:
        s = s[0::2] + s[1::2]
    return s[0]


def make_exact_matrix(
    dim: int, seed: int = 0, lo: int = -3, hi: int = 3, diag: int = 40
) -> np.ndarray:
    """Symmetric integer-valued float32 matrix with a dominant eigenvalue.

    Entries are small integers (plus an integer diagonal boost), so with a
    :func:`quantize_unit` iterate every partial sum of ``X @ w`` stays an
    exact multiple of the grid well inside float32's mantissa — the
    construction the runner's ``verify="exact"`` mode relies on. Keep the
    entry range modest: the exactness argument needs
    ``dim * max|X| * max|w|`` comfortably below ``2^24 / 2^bits``.
    """
    rng = np.random.default_rng(seed)
    a = rng.integers(lo, hi + 1, size=(dim, dim))
    return (a + a.T + diag * np.eye(dim, dtype=np.int64)).astype(np.float32)


def quantize_unit(v: np.ndarray, bits: int = 8) -> np.ndarray:
    """Normalize then snap to the 2^-bits grid (entries exactly representable).

    With integer-valued X and a grid-valued w, every partial sum of
    ``X @ w`` is an exact multiple of 2^-bits well inside float32's 24-bit
    mantissa — so the distributed combine is bit-identical to a float64 host
    reference regardless of block order, and the runner's ``verify="exact"``
    mode holds at every step.

    The math is float32 with a :func:`_tree_sumsq` norm: a fully explicit
    elementwise schedule, bit for bit the JAX package's iterate update.
    """
    v = np.asarray(v, dtype=np.float32)
    u = v / np.sqrt(_tree_sumsq(v, np))
    q = (np.round(u * (1 << bits)) / np.float32(1 << bits)).astype(np.float32)
    if not np.any(q):
        q = np.zeros_like(u)
        q[int(np.argmax(np.abs(v)))] = 1.0
    return q


def unit_vector(v: np.ndarray) -> np.ndarray:
    """Float32 normalize with the :func:`_tree_sumsq` schedule — the
    unquantized iterate update, bitwise-reproducible on device."""
    v = np.asarray(v, dtype=np.float32)
    return v / np.sqrt(_tree_sumsq(v, np))


@dataclass
class PowerIterationResult:
    reports: List[StepReport]
    eigvec: np.ndarray
    eigval: float
    residuals: List[float]          # ||X w - lambda w|| / ||X w|| per step
    churn_events: int
    plans_compiled: int
    cache_hits: int
    total_waste: int
    executor_cache_size: int

    @property
    def total_modeled_latency(self) -> float:
        return float(sum(r.modeled_completion for r in self.reports))

    @property
    def steps_per_sec(self) -> float:
        wall = sum(r.wall_s for r in self.reports)
        return len(self.reports) / wall if wall > 0 else float("inf")


def run_power_iteration(
    runner: ElasticRunner,
    n_steps: int,
    events=None,
    w0: Optional[np.ndarray] = None,
    straggler_sets=None,
    quantize_bits: Optional[int] = 8,
    seed: int = 0,
) -> PowerIterationResult:
    """Deprecated shim: drive elastic power iteration through a churn trace.

    Twin of :func:`repro.runtime.run_power_iteration`. The loop lives in
    :class:`repro_torch.api.workload.MatVecPowerIteration` driven by
    :class:`repro_torch.api.ElasticEngine` (``backend="device"``); this
    wrapper adopts the given runner (:meth:`ElasticEngine.from_runner`) and
    delegates, returning the same :class:`PowerIterationResult` bit for bit.
    New code should call the engine directly.

    ``events`` yields at most one ``ElasticEvent`` per step;
    ``straggler_sets`` is an indexable of per-step straggler sets or a
    callable ``(step, membership) -> sequence`` evaluated after the step's
    event is applied. With ``quantize_bits`` the iterate stays on an
    exactly representable grid (:func:`quantize_unit`), which is what makes
    the runner's exact verification meaningful.
    """
    import warnings

    from repro_torch.api import ElasticEngine, MatVecPowerIteration

    warnings.warn(
        "run_power_iteration is deprecated; use repro_torch.api."
        "ElasticEngine(MatVecPowerIteration(...), ..., backend='device')",
        DeprecationWarning, stacklevel=2,
    )
    workload = MatVecPowerIteration(w0=w0, quantize_bits=quantize_bits,
                                    seed=seed)
    res = ElasticEngine.from_runner(runner, workload).run(
        n_steps=n_steps, events=events, straggler_sets=straggler_sets)
    return res.result
