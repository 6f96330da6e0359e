"""Live elastic execution on the card: the churn-driven device backend.

The port of :mod:`repro.runtime.elastic_runner`, barrier consume, one step
per dispatch. It closes the loop the paper runs on EC2 (§V): an
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

The static-shape contract: every array is padded to the **max-N membership**
(the full machine population). A preempted machine is a worker slot with
``n_blocks == 0`` and all-zero include weights. Membership changes therefore
swap plan arrays; the executor is built once per runner and the kernel
library is loaded once per process (:attr:`ElasticRunner.executor_cache_size`
stays at 1, the reference's jit-cache telemetry).

Per-worker step times: a single card cannot observe heterogeneous worker
speeds, so the runner takes a pluggable clock — :class:`HostSharedClock`
apportions the measured step wall time by row share, and
:class:`SyntheticSpeedClock` replays a heterogeneous speed process so runs
exercise the EWMA adaptation reproducibly. Real step wall time (host clock
around a synchronized executor call) is always measured and reported.

Not ported yet (each raises ``NotImplementedError`` at construction, naming
its ROADMAP.md item): ``arrival="first"``, ``fuse_steps > 1``,
``dispatch_timeout`` and ``verify_results``. This module imports torch only
when a runner is built, so the host-side classes work without it.
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
    "arrival='first'": "item 5 (first-arrival)",
    "fuse_steps > 1": "item 6 (fused windows)",
    "kill_scheduler_at": "item 7 (engine scheduler kill)",
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
    fuse_steps: K, iterations per device dispatch. Only 1 is ported.
    segmented: per-worker block-list execution — None keeps the per-block
      loop (one ``usec_matvec`` launch per real block); "auto"/"cuda"/"ref"
      route every worker's whole block list through the workload's
      ``segmented_fn`` (one ``usec_segmented`` launch a step on the card).
    arrival: the master's consume rule. Only ``"barrier"`` is ported.
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
        if self.arrival == "first":
            raise not_ported("arrival='first'")
        if self.fuse_steps != 1:
            raise not_ported("fuse_steps > 1")
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
    jit_cache_size: int        # executors built so far (stays 1)
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

        from .executor import make_matvec_executor, resolve_device, stage_matrix

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
        self._executor = make_matvec_executor(
            rows_total=q, block_rows=cfg.block_rows,
            matmul=workload.executor_fn(cfg.matmul_mode),
            out_cols=workload.out_cols,
            segmented_fn=seg_fn,
        )
        self._executors_built = 1
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
        """Executors built by this runner (expected: 1 forever — churn and
        worker identity are data). The port's analog of the reference's
        jit cache size; the kernel library itself loads once per process."""
        return self._executors_built

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
    def _sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(
        self,
        w: np.ndarray,
        event: Optional[ElasticEvent] = None,
        stragglers: Optional[Sequence[int]] = None,
    ) -> Tuple[np.ndarray, StepReport]:
        """Execute one elastic step ``y = X @ w`` under the current plan.

        ``event`` (if any) is applied before planning. ``stragglers=None``
        masks no copies; an explicit sequence *injects* that realized
        straggler set — masked copies are dropped from the combine (include
        weights), exactly one surviving holder per segment delivers. Raises
        ``ValueError`` on an out-of-range id and errors out if the set
        exceeds the plan's tolerance. Returns ``y`` as host NumPy.
        """
        import torch

        from .executor import refresh_include

        if event is not None:
            self.apply_event(event)
        t0 = time.perf_counter()
        # Feed last step's measured durations into the EWMA (Alg. 1 line 4)
        # BEFORE planning, so the plan sees the freshest estimates.
        self.ingest_pending()
        bad: Tuple[int, ...] = ()
        if stragglers is not None:
            bad = tuple(sorted({int(s) for s in stragglers}))
            self._check_straggler_ids(bad)
        entry, cache_hit, replanned, waste = self._adopt_plan()
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
        self.device_dispatches += 1
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

    ``xp`` is the array module (numpy here). Library reductions choose their
    own accumulation order, so a host value and a device twin can disagree
    in the last ulp. This reduction pins the order: square, zero-pad to a
    power of two, halve by adding strided slices. Every step is an
    elementwise IEEE op, so any backend that follows the schedule produces
    the SAME bits as the reference package's :func:`quantize_unit`.
    """
    s = v * v
    n = 1
    while n < s.shape[0]:
        n *= 2
    if n != s.shape[0]:
        s = xp.concatenate([s, xp.zeros(n - s.shape[0], s.dtype)])
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

