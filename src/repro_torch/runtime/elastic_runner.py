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

Planning faults (``scheduler_kill``, ``stale_plan_table``) fire at a step's
head through :attr:`ElasticRunner.fault_injector`. Not ported yet (each
raises ``NotImplementedError`` naming its ROADMAP.md item): the dispatch and
corruption fault kinds, ``dispatch_timeout`` and ``verify_results``. This
module imports torch only when a runner is built, so the host-side classes
work without it.
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

# Where each unported knob will land (ROADMAP.md, Queue 1).
ROADMAP_ITEM = {
    "dispatch_timeout": "item 8 (faults + integrity)",
    "faults": "item 8 (faults + integrity)",
    "verify_results": "item 8 (faults + integrity)",
    "checkpointing": "item 9 (checkpoint)",
    "prepare/submit": "item 10 (serving)",
}


def not_ported(knob: str) -> NotImplementedError:
    """The error for a reference feature this package does not have yet."""
    return NotImplementedError(
        f"{knob} is not ported to repro_torch yet: ROADMAP.md Queue 1 "
        f"{ROADMAP_ITEM[knob]}")


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
    dispatch_timeout / verify_results: not ported; must stay None / "off".
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
        if self.dispatch_timeout is not None:
            raise not_ported("dispatch_timeout")
        if self.verify_results != "off":
            raise not_ported("verify_results")


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
        mm = workload.executor_fn(cfg.matmul_mode)
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
        # Unannounced-failure seam (repro_torch.faults): consulted at each
        # step's head. The planning kinds fire here; the others are not
        # ported yet and raise.
        self.fault_injector = None

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
    # and consumed at each step's head.
    # ------------------------------------------------------------------ #
    def _consult_planning_faults(self, t: int) -> None:
        """Fire planning-path faults scheduled at absolute step ``t``:
        ``scheduler_kill`` tombstones the central master (the decentral
        replica keeps the run alive), ``stale_plan_table`` drops every
        replicated planning artifact. Both are consumed one-shot. Any other
        kind scheduled at ``t`` raises: its seam is not ported yet."""
        inj = self.fault_injector
        if inj is None:
            return
        from repro_torch.faults.chaos import FAULT_KINDS, PLANNING_KINDS

        others = tuple(k for k in FAULT_KINDS if k not in PLANNING_KINDS)
        if inj.has_fault(t, kinds=others):
            raise not_ported("faults")
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

    def _derive_realized(self, durations: Dict[int, float]
                         ) -> Tuple[int, ...]:
        """Realized straggler set from modeled arrival order: the master
        consumes the first ``n_loaded - S`` completions, so the slowest S
        loaded workers (ties broken by id) are this step's stragglers. At
        least one worker is always consumed."""
        S = self._master.stragglers
        s_eff = min(S, max(len(durations) - 1, 0))
        if s_eff <= 0:
            return ()
        order = sorted(durations, key=lambda n: (durations[n], n))
        return tuple(sorted(int(n) for n in order[len(order) - s_eff:]))

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
        """
        import torch

        from .executor import refresh_include

        replan_s = time.perf_counter() - t0
        loaded = [n for n in self._membership
                  if entry.block.n_blocks[n] > 0]
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
        durations = self.clock.durations(row_loads, self._membership, wall)
        if injected is None:
            realized = self._derive_realized(durations)
        else:
            realized = tuple(injected)
        # Host-side feasibility + winner weights: include_mask raises when a
        # segment lost every holder, exactly like the barrier path.
        include = refresh_include(entry.block, entry.step_plan.plan, realized)
        y = self._winner_combine(parts, loaded, entry, include)

        self._pending_loads = {
            n: float(entry.block_loads[n]) for n in durations
        }
        self._pending_durations = durations
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
        tolerance. Planning faults scheduled at this step fire first.
        Returns ``y`` as host NumPy.
        """
        import torch

        from .executor import refresh_include

        if event is not None:
            self.apply_event(event)
        self._consult_planning_faults(self._step)
        t0 = time.perf_counter()
        # Feed last step's measured durations into the EWMA (Alg. 1 line 4)
        # BEFORE planning, so the plan sees the freshest estimates.
        self.ingest_pending()
        injected: Optional[Tuple[int, ...]] = None
        if stragglers is not None:
            injected = tuple(sorted({int(s) for s in stragglers}))
            self._check_straggler_ids(injected)
        entry, cache_hit, replanned, waste = self._adopt_plan()
        if self.cfg.arrival == "first":
            return self._step_first(
                w, entry, cache_hit, replanned, waste, t0, injected)
        bad = injected or ()
        include_d = (
            None if not bad
            else torch.as_tensor(
                refresh_include(entry.block, entry.step_plan.plan, bad),
                device=self.device)
        )
        replan_s = time.perf_counter() - t0

        w_dev = torch.as_tensor(w)
        self._sync()
        t1 = time.perf_counter()
        y = self._executor(
            self._staged_dev, entry.dev, w_dev.to(self.device), include_d)
        self._sync()
        wall = time.perf_counter() - t1
        self._drivers_run.add("step")
        self.device_dispatches += 1
        self._last_step_wall = wall
        y = y.cpu().numpy()

        row_loads = entry.block_loads * self.rows_per_tile
        durations = self.clock.durations(row_loads, self._membership, wall)
        # The EWMA is fed tile-unit loads (the LP's unit), so estimated
        # speeds stay consistent with the planner; clocks see row units.
        self._pending_loads = {
            n: float(entry.block_loads[n]) for n in durations
        }
        self._pending_durations = durations
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
        return y, report

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
            if events[k] is not None:
                self.apply_event(events[k])
            # Fault seams fire at assembly time, per step, before anything
            # dispatches.
            self._consult_planning_faults(base + k)
            entry, cache_hit, replanned, waste = self._adopt_plan()
            had_miss = had_miss or not cache_hit
            durs_k = None
            if sets[k] is None:
                if self.cfg.arrival == "first":
                    # Derive this step's realized stragglers at assembly
                    # time: the on-card include gather needs the bitmask
                    # before dispatch, so the clock is sampled here (once
                    # per step, in step order, the stepwise cadence)
                    # against the previous dispatch's per-step wall.
                    row_loads = entry.block_loads * self.rows_per_tile
                    durs_k = self.clock.durations(
                        row_loads, self._membership, self._last_step_wall)
                    sets[k] = self._derive_realized(durs_k)
                else:
                    sets[k] = ()
            else:
                self._check_straggler_ids(sets[k])
            if sets[k]:
                # Host-side feasibility check (the device gather cannot
                # raise): include_mask errors out when a segment lost every
                # holder, exactly like the stepwise path.
                entry.step_plan.plan.include_mask(sets[k])
                bad[k, list(sets[k])] = True
            metas.append((self._membership, entry, replanned, cache_hit,
                          time.perf_counter() - t0, waste, durs_k))
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
            per_step_durs.append(durs)
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
        for k, (avail, entry, replanned, cache_hit, replan_s, waste,
                _d) in enumerate(metas):
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

