"""Wall-clock simulation of USEC steps on heterogeneous elastic clusters.

The *latency* claims of the paper are validated analytically here, exactly
as the paper's model defines them (the live execution path is
:mod:`repro_torch.runtime.elastic_runner`, whose benchmark cross-checks its
measured step times against these predictions):

  worker n's finish time  t_n = mu[n] / s[n]        (Definition 3)
  step completion         = earliest time by which every segment has been
                            delivered by at least one of its 1+S holders
                            (the master's "first N_t - S results" semantics)

Two evaluation paths share those semantics:

- :func:`simulate_step` — the scalar oracle, one (plan, speeds, dropped)
  scenario per call. Kept deliberately simple; the batched path is
  differential-tested against it.
- :func:`simulate_batch` — the vectorized engine: thousands of
  (speeds, straggler-set) draws against one plan or a :class:`PlanStack`
  of plans (one per availability state) in a single NumPy pass. Completion
  time per draw is ``max over segments of min over non-dropped group
  members of t_n`` — provably identical to the scalar prefix-cover scan,
  because the earliest covering prefix ends exactly at that max-min time.

The simulator also generates realistic speed processes (exponential draws as
in Fig. 2, plus drifting/noisy speeds for the adaptive EWMA study) and
straggler processes (uniform random, targeted-slowest, persistent), both in
scalar and batched form.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.plan import CompiledPlan


@dataclass
class StepTiming:
    """Timing outcome of one simulated USEC step."""

    finish_times: np.ndarray          # (N,) per-worker finish time (inf if preempted)
    completion_time: float            # when the master could reconstruct y
    used_workers: Tuple[int, ...]     # workers whose results the master used
    straggled: Tuple[int, ...]        # workers slower than the completion time


def worker_times(plan: CompiledPlan, speeds: np.ndarray) -> np.ndarray:
    """t_n = load_n / s_n with load in tile units (paper Definition 3)."""
    loads = plan.loads()
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(loads > 0, loads / np.maximum(speeds, 1e-300), 0.0)
    return t


def simulate_step(
    plan: CompiledPlan,
    speeds: np.ndarray,
    dropped: Sequence[int] = (),
) -> StepTiming:
    """Completion = min over worker-finish-order prefixes that cover all
    segments (workers in ``dropped`` never deliver)."""
    t = worker_times(plan, speeds)
    n = plan.n_machines
    drop = set(int(d) for d in dropped)
    order = sorted(
        (w for w in range(n) if plan.n_valid[w] > 0 and w not in drop),
        key=lambda w: t[w],
    )
    needed = {sid: set(seg.group) for sid, seg in enumerate(plan.segments)}
    pending = set(needed)
    arrived: List[int] = []
    completion = float("inf")
    for w in order:
        arrived.append(w)
        done = [sid for sid in pending if w in needed[sid]]
        for sid in done:
            pending.discard(sid)
        if not pending:
            completion = t[w]
            break
    if pending:
        raise RuntimeError(
            f"segments {sorted(pending)} undeliverable; dropped={sorted(drop)} "
            f"exceeds the plan's straggler tolerance S={plan.stragglers}"
        )
    used = tuple(arrived)
    straggled = tuple(
        w for w in range(n)
        if plan.n_valid[w] > 0 and (w in drop or t[w] > completion + 1e-15)
    )
    return StepTiming(t, completion, used, straggled)


# ---------------------------------------------------------------------- #
# Batched scenario engine
# ---------------------------------------------------------------------- #
@dataclass
class PlanStack:
    """A stack of ``P`` compiled plans, padded to a common segment count.

    One plan per availability/tolerance state; draws reference plans by
    index, so one :func:`simulate_batch` call can sweep scenarios that mix
    membership states without re-entering Python per draw.

    Attributes:
      loads: (P, N) per-plan per-machine loads in tile units.
      seg_group: (P, S_max, L) group member ids, -1 on padded segments.
      seg_valid: (P, S_max) bool, False on padding.
      active: (P, N) bool, workers with at least one segment.
      stragglers: per-plan S (informational).
    """

    n_machines: int
    loads: np.ndarray
    seg_group: np.ndarray
    seg_valid: np.ndarray
    active: np.ndarray
    stragglers: Tuple[int, ...]

    @property
    def n_plans(self) -> int:
        return self.loads.shape[0]

    @classmethod
    def from_batch(cls, plans: Sequence[CompiledPlan]) -> "PlanStack":
        """Stack the output of :func:`repro_torch.core.plan.compile_plan_batch`
        (or any list of compiled plans over one machine population) into a
        single batched-simulation operand. Alias of
        :func:`build_plan_stack`, named for the batch-compile pipeline:
        ``compile_plan_batch(...)`` → ``PlanStack.from_batch(...)`` →
        :func:`simulate_batch`."""
        return build_plan_stack(plans)


def build_plan_stack(plans: Sequence[CompiledPlan]) -> PlanStack:
    """Pad per-segment arrays of several plans into one batched stack.

    All plans must be over the same machine population N; segment counts and
    straggler tolerances may differ (group width is padded to the max 1+S by
    repeating each group's first member, which never changes a min over the
    group).
    """
    if not plans:
        raise ValueError("need at least one plan")
    N = plans[0].n_machines
    if any(p.n_machines != N for p in plans):
        raise ValueError("all plans must cover the same machine population")
    s_max = max(max(p.n_segments, 1) for p in plans)
    l_max = max(1 + p.stragglers for p in plans)
    P = len(plans)
    loads = np.zeros((P, N))
    seg_group = np.full((P, s_max, l_max), -1, dtype=np.int32)
    seg_valid = np.zeros((P, s_max), dtype=bool)
    active = np.zeros((P, N), dtype=bool)
    for i, p in enumerate(plans):
        loads[i] = p.loads()
        _, _, _, group, _ = p.seg_arrays()
        k, L = group.shape
        if k:
            seg_group[i, :k, :L] = group
            if L < l_max:  # repeat a real member into the padding columns
                seg_group[i, :k, L:] = group[:, :1]
            seg_valid[i, :k] = True
        active[i] = np.asarray(p.n_valid) > 0
    return PlanStack(
        n_machines=N,
        loads=loads,
        seg_group=seg_group,
        seg_valid=seg_valid,
        active=active,
        stragglers=tuple(p.stragglers for p in plans),
    )


@dataclass
class BatchTiming:
    """Timing outcome of a batch of simulated USEC steps.

    ``completion_times`` is +inf on infeasible draws (some segment lost all
    of its holders) when ``on_infeasible="inf"``.
    """

    finish_times: np.ndarray       # (B, N)
    completion_times: np.ndarray   # (B,)
    feasible: np.ndarray           # (B,) bool
    n_straggled: np.ndarray        # (B,) int64

    @property
    def n_draws(self) -> int:
        return self.completion_times.shape[0]


def _as_drop_mask(dropped, B: int, N: int) -> np.ndarray:
    if dropped is None:
        return np.zeros((B, N), dtype=bool)
    if isinstance(dropped, np.ndarray) and dropped.ndim >= 1 \
            and (dropped.ndim == 2 or dropped.dtype == bool):
        # Any 2-D array is a mask (0/1 ints included — iterating its rows
        # as index collections would silently corrupt the draw).
        if dropped.shape == (B, N):
            return dropped.astype(bool, copy=False)
        if dropped.shape == (N,):
            return np.broadcast_to(dropped.astype(bool, copy=False), (B, N))
        raise ValueError(f"drop mask must be ({B}, {N}) or ({N},); "
                         f"got {dropped.shape}")
    # sequence of per-draw index collections (possibly ragged)
    seqs = list(dropped)
    if len(seqs) != B:
        raise ValueError(
            f"dropped has {len(seqs)} entries for {B} draws; "
            "per-draw index collections must match the speed batch")
    mask = np.zeros((B, N), dtype=bool)
    for b, idxs in enumerate(seqs):
        idx = np.asarray(list(idxs), dtype=np.int64)
        if idx.size:
            mask[b, idx] = True
    return mask


def simulate_batch(
    plan,
    speeds: np.ndarray,
    dropped=None,
    plan_index: Optional[np.ndarray] = None,
    on_infeasible: str = "raise",
    completion: str = "coverage",
) -> BatchTiming:
    """Vectorized :func:`simulate_step` over a batch of scenario draws.

    Args:
      plan: a :class:`CompiledPlan` or a :class:`PlanStack`.
      speeds: (B, N) per-draw realized speeds ((N,) broadcasts).
      dropped: per-draw straggler sets — (B, N) bool mask, or a sequence of
        B index collections, or None.
      plan_index: (B,) int plan selector when ``plan`` is a stack (defaults
        to all-zeros).
      on_infeasible: "raise" (scalar-oracle parity: any draw that loses all
        holders of some segment is an error) or "inf" (mark the draw
        infeasible and set its completion time to +inf — the sweep driver's
        mode, where e.g. an S=0 policy is *expected* to fail under forced
        stragglers).
      completion: the master's consume model.
        ``"coverage"`` (default, the legacy analytic model): per draw, the
        time every segment has at least one non-dropped holder finished —
        max over segments of min over surviving group members. An idealized
        per-segment master; bit-compatible with :func:`simulate_step`.
        ``"order"``: the first-arrival runner's rule — the
        ``(n_active - S)``-th order statistic of the active workers' finish
        times (dropped workers never arrive), the completion the
        ``arrival="first"`` runner realizes when it consumes the first
        ``N_t - S`` results.
        ``"barrier"``: max over active workers' finish times (dropped →
        never), what a bulk-synchronous ``arrival="barrier"`` step pays.
        Both non-default models mark draws whose wait never ends (too many
        drops) infeasible under ``on_infeasible="inf"``.

    Returns:
      :class:`BatchTiming`. On feasible draws with ``completion="coverage"``
      ``completion_times[b]`` equals
      ``simulate_step(plan_b, speeds[b], dropped_b).completion_time`` bit for
      bit.
    """
    if completion not in ("coverage", "order", "barrier"):
        raise ValueError(
            f"completion must be 'coverage', 'order' or 'barrier'; "
            f"got {completion!r}")
    stack = plan if isinstance(plan, PlanStack) else build_plan_stack([plan])
    N = stack.n_machines
    speeds = np.asarray(speeds, dtype=np.float64)
    if speeds.ndim == 1:
        speeds = speeds[None, :]
    B = speeds.shape[0]
    if speeds.shape != (B, N):
        raise ValueError(f"speeds must be (B, {N}); got {speeds.shape}")
    pi = (
        np.zeros(B, dtype=np.int64) if plan_index is None
        else np.asarray(plan_index, dtype=np.int64)
    )
    if pi.shape != (B,):
        raise ValueError(f"plan_index must be ({B},); got {pi.shape}")
    if pi.size and (pi.min() < 0 or pi.max() >= stack.n_plans):
        raise ValueError("plan_index out of range")
    drop = _as_drop_mask(dropped, B, N)

    loads = stack.loads[pi]                                     # (B, N)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(loads > 0, loads / np.maximum(speeds, 1e-300), 0.0)

    # Group draws by plan: each subset evaluates against its plan's
    # *unpadded* segment table, so small plans in a stack never pay for the
    # largest plan's padding.
    comp = np.zeros(B)
    feasible = np.ones(B, dtype=bool)
    for p in np.unique(pi) if stack.n_plans > 1 else (0,):
        sel = slice(None) if stack.n_plans == 1 else (pi == p)
        group_p = stack.seg_group[p][stack.seg_valid[p]]         # (S_p, L)
        if group_p.shape[0] == 0:
            continue
        member_t = t[sel][:, group_p]                            # (B_p, S_p, L)
        member_t = np.where(drop[sel][:, group_p], np.inf, member_t)
        seg_time = member_t.min(axis=2)                          # (B_p, S_p)
        lost = ~np.isfinite(seg_time)
        feas_p = ~lost.any(axis=1)
        if not feas_p.all() and on_infeasible == "raise":
            local = int(np.argmin(feas_p))
            b = local if stack.n_plans == 1 else int(np.flatnonzero(sel)[local])
            sid = int(np.argmax(lost[local]))
            raise RuntimeError(
                f"draw {b}: segment {sid} undeliverable; "
                f"dropped={sorted(np.flatnonzero(drop[b]).tolist())} exceeds "
                f"the plan's straggler tolerance S={stack.stragglers[p]}"
            )
        if completion == "coverage":
            comp_p = np.where(
                feas_p, np.where(lost, -np.inf, seg_time).max(axis=1), np.inf)
        else:
            # Worker-granular consume rules. A dropped worker never arrives
            # (finish = +inf); inactive workers are not waited on.
            act = stack.active[p]                                # (N,)
            tw = np.where(act[None, :], t[sel], np.inf)          # (B_p, N)
            tw = np.where(drop[sel] & act[None, :], np.inf, tw)
            n_act = int(act.sum())
            if completion == "order":
                # First-arrival master: wait for the (n_act - S)-th arrival
                # (never fewer than one).
                s_p = int(stack.stragglers[p])
                k = n_act - min(s_p, max(n_act - 1, 0))
            else:  # "barrier"
                k = n_act
            if n_act == 0:  # pragma: no cover - plans always assign work
                comp_p = np.zeros(tw.shape[0])
            else:
                comp_p = np.partition(tw, k - 1, axis=1)[:, k - 1]
            # Too many drops for the consume rule to ever return: the wait
            # never completes, on top of the coverage feasibility above.
            comp_p = np.where(feas_p, comp_p, np.inf)
            feas_p = feas_p & np.isfinite(comp_p)
            if not feas_p.all() and on_infeasible == "raise":
                local = int(np.argmin(feas_p))
                b = (local if stack.n_plans == 1
                     else int(np.flatnonzero(sel)[local]))
                raise RuntimeError(
                    f"draw {b}: {completion!r} completion never reached; "
                    f"dropped="
                    f"{sorted(np.flatnonzero(drop[b]).tolist())} exceeds "
                    f"the plan's straggler tolerance S={stack.stragglers[p]}"
                )
        comp[sel] = comp_p
        feasible[sel] = feas_p

    active = stack.active[pi]                                    # (B, N)
    straggled = active & (drop | (t > comp[:, None] + 1e-15))
    return BatchTiming(
        finish_times=t,
        completion_times=comp,
        feasible=feasible,
        n_straggled=straggled.sum(axis=1),
    )


# ---------------------------------------------------------------------- #
# Speed / straggler processes
# ---------------------------------------------------------------------- #
@dataclass
class SpeedProcess:
    """Per-step true speeds: base draw + lognormal jitter + optional drift.

    Models the paper's EC2 observation: same instance type, persistently
    different speeds, with step-to-step noise.
    """

    base: np.ndarray
    jitter_sigma: float = 0.0
    drift_sigma: float = 0.0
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._drift = np.ones_like(self.base)

    def sample(self) -> np.ndarray:
        if self.drift_sigma > 0:
            self._drift *= np.exp(self._rng.normal(0, self.drift_sigma, self.base.shape))
            self._drift = np.clip(self._drift, 0.25, 4.0)
        jit = (
            np.exp(self._rng.normal(0, self.jitter_sigma, self.base.shape))
            if self.jitter_sigma > 0 else 1.0
        )
        return self.base * self._drift * jit


def exponential_speeds(n: int, mean: float = 1.0, seed: int = 0,
                       floor: float = 1e-3) -> np.ndarray:
    """The paper's Fig. 2 speed model: i.i.d. exponential draws."""
    rng = np.random.default_rng(seed)
    return np.maximum(rng.exponential(mean, n), floor)


@dataclass
class StragglerProcess:
    """Draws per-step straggler sets.

    mode: "none" | "uniform" (any S of the available) | "slowest"
    (the S slowest true speeds — the adversarial case).
    """

    count: int = 0
    mode: str = "uniform"
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def sample(self, available: Sequence[int], speeds: np.ndarray) -> Tuple[int, ...]:
        if self.count <= 0 or self.mode == "none":
            return ()
        avail = list(available)
        s = min(self.count, max(len(avail) - 1, 0))
        if self.mode == "uniform":
            return tuple(self._rng.choice(avail, size=s, replace=False))
        if self.mode == "slowest":
            return tuple(sorted(avail, key=lambda w: speeds[w])[:s])
        raise ValueError(f"unknown straggler mode {self.mode!r}")

    def sample_batch(
        self,
        available: Sequence[int],
        speeds: np.ndarray,
        n_machines: int,
    ) -> np.ndarray:
        """(B, N) bool straggler masks for a (B, N) speed batch, vectorized.

        Per-draw semantics match :meth:`sample`: ``min(count, |avail|-1)``
        stragglers, chosen uniformly over the available set or as the
        slowest realized speeds of the draw.
        """
        speeds = np.atleast_2d(np.asarray(speeds, dtype=np.float64))
        B = speeds.shape[0]
        mask = np.zeros((B, n_machines), dtype=bool)
        if self.count <= 0 or self.mode == "none":
            return mask
        avail = np.asarray(sorted(int(a) for a in available), dtype=np.int64)
        s = min(self.count, max(avail.size - 1, 0))
        if s == 0:
            return mask
        if self.mode == "uniform":
            key = self._rng.random((B, avail.size))
        elif self.mode == "slowest":
            key = speeds[:, avail]
        else:
            raise ValueError(f"unknown straggler mode {self.mode!r}")
        pick = np.argpartition(key, s - 1, axis=1)[:, :s]   # s smallest keys
        rows = np.repeat(np.arange(B), s)
        mask[rows, avail[pick.ravel()]] = True
        return mask
