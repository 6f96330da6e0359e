"""Batched scenario sweeps: placements × straggler policies × churn traces.

This is the evaluation driver the ROADMAP's "as many scenarios as you can
imagine" goal asks for. It stays entirely on the vectorized path:

- a *static* sweep plans once per (placement, tolerance) cell and evaluates
  thousands of (realized-speed, straggler-set) draws with one
  :func:`repro_torch.runtime.simulate.simulate_batch` call per cell;
- a *churn* sweep walks an availability trace, re-plans per membership state
  (memoized — revisited states reuse their compiled plan), stacks the plans,
  and evaluates all (step, draw) pairs in one batched call, alongside
  per-transition waste accounting. The walk itself now lives in the
  simulate backend of :class:`repro_torch.api.ElasticEngine`;
  :func:`sweep_churn` is a bit-exact shim over it.

Sweeps carry a *workload* axis: any :class:`repro_torch.api.Workload` scales the
analytical times by its per-row cost relative to matvec (``cost_scale()``).

Everything returns plain arrays/dataclasses so benchmarks and schedulers can
consume distributions directly (the scheduler's straggler-tolerance lookahead
is exactly a small static sweep over S candidates).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.placement import Placement
from repro_torch.core.assignment import solve_assignment
from repro_torch.core.plan import compile_plan, compile_plan_batch

from .simulate import PlanStack, StragglerProcess, simulate_batch


# ---------------------------------------------------------------------- #
# Config / result containers
# ---------------------------------------------------------------------- #
@dataclass(frozen=True)
class SweepConfig:
    """Knobs shared by every cell of a sweep.

    n_draws: scenario draws per cell.
    rows_per_tile: plan integerization granularity.
    speed_mean: mean of the exponential base-speed draw (Fig. 2 model).
    jitter_sigma: lognormal jitter applied to the *realized* speeds around
      the speeds the planner saw (0 = planner is clairvoyant).
    plan_speeds: optional (N,) speeds the planner uses; default = the base
      draw's mean vector (heterogeneous planning needs explicit speeds).
    seed: base RNG seed; each cell derives an independent stream.
    """

    n_draws: int = 1000
    rows_per_tile: int = 96
    speed_mean: float = 1.0
    jitter_sigma: float = 0.3
    plan_speeds: Optional[np.ndarray] = None
    seed: int = 0


def summarize(times: np.ndarray) -> Dict[str, float]:
    """Distribution summary of completion times; inf-aware."""
    t = np.asarray(times, dtype=np.float64)
    finite = t[np.isfinite(t)]
    out = {
        "n": int(t.size),
        "feasible_frac": float(finite.size / t.size) if t.size else 0.0,
    }
    if finite.size:
        out.update(
            mean=float(finite.mean()),
            std=float(finite.std()),
            p50=float(np.percentile(finite, 50)),
            p95=float(np.percentile(finite, 95)),
            p99=float(np.percentile(finite, 99)),
            max=float(finite.max()),
        )
    else:
        out.update(mean=float("inf"), std=0.0, p50=float("inf"),
                   p95=float("inf"), p99=float("inf"), max=float("inf"))
    return out


@dataclass
class ScenarioResult:
    """One sweep cell: a named scenario and its completion-time distribution."""

    name: str
    placement: str
    tolerance: int
    straggler_mode: str
    n_stragglers: int
    completion_times: np.ndarray     # (B,), +inf on infeasible draws
    n_straggled: np.ndarray          # (B,)
    c_star: float                    # planner's optimum under plan speeds
    summary: Dict[str, float] = field(default_factory=dict)
    workload: str = "matvec"         # workload axis (cost-scaled times)

    def __post_init__(self):
        if not self.summary:
            self.summary = summarize(self.completion_times)


@dataclass
class ChurnStep:
    """One step of a churn sweep."""

    step: int
    available: Tuple[int, ...]
    c_star: float
    replanned: bool
    waste: int
    summary: Dict[str, float]


@dataclass
class ChurnSweepResult:
    steps: List[ChurnStep]
    completion_times: np.ndarray     # (steps, draws)
    total_waste: int

    def per_step_mean(self) -> np.ndarray:
        t = self.completion_times.copy()
        t[~np.isfinite(t)] = np.nan
        return np.nanmean(t, axis=1)


# ---------------------------------------------------------------------- #
# Static sweep: placements × (tolerance, straggler policy)
# ---------------------------------------------------------------------- #
def draw_scenarios(
    plan_speeds: np.ndarray,
    n_draws: int,
    jitter_sigma: float,
    rng: np.random.Generator,
    available: Sequence[int],
    n_stragglers: int = 0,
    straggler_mode: str = "none",
    floor: float = 1e-6,
) -> Tuple[np.ndarray, np.ndarray]:
    """Draw a (realized-speeds, straggler-mask) scenario batch.

    The single environment model shared by sweep cells and the scheduler's
    tolerance lookahead: realized speeds are the planner's speeds with
    lognormal jitter (floored), straggler sets come from
    :class:`StragglerProcess` semantics. Returns ((B, N) speeds, (B, N) bool).
    """
    s = np.asarray(plan_speeds, dtype=np.float64)
    N = s.shape[0]
    jitter = (
        np.exp(rng.normal(0.0, jitter_sigma, (n_draws, N)))
        if jitter_sigma > 0 else np.ones((n_draws, N))
    )
    realized = np.maximum(s[None, :] * jitter, floor)
    proc = StragglerProcess(count=n_stragglers, mode=straggler_mode,
                            seed=int(rng.integers(2 ** 31)))
    drop = proc.sample_batch(available, realized, N)
    return realized, drop


def sweep_cell(
    name: str,
    placement: Placement,
    tolerance: int,
    straggler_mode: str,
    n_stragglers: int,
    cfg: SweepConfig,
    rng: Optional[np.random.Generator] = None,
    workload=None,
) -> ScenarioResult:
    """Plan one (placement, S) cell and evaluate ``cfg.n_draws`` scenarios.

    ``workload`` (a :class:`repro_torch.api.Workload`) scales the analytical
    completion times by its per-row cost relative to matvec
    (``cost_scale()``); None keeps the raw matvec times bit-for-bit.
    """
    rng = rng or np.random.default_rng(cfg.seed)
    N = placement.n_machines
    if cfg.plan_speeds is not None:
        s_plan = np.asarray(cfg.plan_speeds, dtype=np.float64)
    else:
        s_plan = np.maximum(rng.exponential(cfg.speed_mean, N), 1e-3)
    sol = solve_assignment(placement, s_plan, stragglers=tolerance,
                           lexicographic=False)
    plan = compile_plan(placement, sol, rows_per_tile=cfg.rows_per_tile,
                        stragglers=tolerance, speeds=s_plan)
    avail = [n for n in range(N) if plan.n_valid[n] > 0]
    realized, drop = draw_scenarios(
        s_plan, cfg.n_draws, cfg.jitter_sigma, rng, avail,
        n_stragglers=n_stragglers, straggler_mode=straggler_mode)
    timing = simulate_batch(plan, realized, dropped=drop,
                            on_infeasible="inf")
    times = timing.completion_times
    c_star = sol.c_star
    scale = 1.0 if workload is None else float(workload.cost_scale())
    if scale != 1.0:
        # Times and the planner's optimum scale together, so overhead
        # ratios (time / c_star) stay unit-free.
        times = times * scale
        c_star = c_star * scale
    return ScenarioResult(
        name=name,
        placement=placement.name,
        tolerance=tolerance,
        straggler_mode=straggler_mode,
        n_stragglers=n_stragglers,
        completion_times=times,
        n_straggled=timing.n_straggled,
        c_star=c_star,
        workload="matvec" if workload is None else workload.name,
    )


def sweep_grid(
    placements: Mapping[str, Placement],
    tolerances: Sequence[int] = (0, 1),
    straggler_policies: Sequence[Tuple[str, int]] = (("none", 0),),
    cfg: SweepConfig = SweepConfig(),
    workloads: Optional[Mapping[str, "object"]] = None,
    batched: bool = True,
) -> List[ScenarioResult]:
    """Cross workloads × placements × tolerances × straggler policies.

    ``straggler_policies`` are (mode, count) pairs, e.g. ("uniform", 1) or
    ("slowest", 2). Cells whose placement cannot tolerate S stragglers
    (replication < 1+S) are skipped. Each cell's RNG stream is derived from
    (cfg.seed, cell name) alone, so a cell's distribution is reproducible
    regardless of which other cells are in the grid.

    ``workloads`` adds the workload axis: a mapping of label ->
    :class:`repro_torch.api.Workload`; each cell is crossed with every workload
    and named ``{wname}/{pname}/S={S}/{mode}x{count}``. None (the default)
    keeps the legacy matvec-only grid with unprefixed cell names — and the
    exact legacy RNG streams.

    With ``batched`` (the default) the whole grid compiles through ONE
    :func:`repro_torch.core.plan.compile_plan_batch` call and evaluates through
    one stacked :func:`simulate_batch` call per machine population —
    bitwise-identical results to the per-cell path (``batched=False``,
    which simply maps :func:`sweep_cell`), because the batch compiler is
    bit-exact against the scalar one and a stacked simulate evaluates each
    draw against its own plan's unpadded segment table.
    """
    axis = {None: None} if workloads is None else dict(workloads)
    cells = []           # (name, placement, S, mode, count, workload, rng)
    for wname, wl in sorted(axis.items(), key=lambda kv: kv[0] or ""):
        for pname, placement in sorted(placements.items()):
            for S in tolerances:
                if placement.replication < 1 + S:
                    continue
                for mode, count in straggler_policies:
                    name = f"{pname}/S={S}/{mode}x{count}"
                    if wname is not None:
                        name = f"{wname}/{name}"
                    rng = np.random.default_rng(np.random.SeedSequence(
                        [cfg.seed, zlib.crc32(name.encode("utf-8"))]))
                    cells.append(
                        (name, placement, S, mode, count, wl, rng))
    if not batched:
        return [
            sweep_cell(name, placement, S, mode, count, cfg, rng,
                       workload=wl)
            for name, placement, S, mode, count, wl, rng in cells
        ]
    if not cells:
        return []

    # Phase 1 — per-cell plan speeds + LP solve, in cell order (each cell's
    # RNG consumption is exactly sweep_cell's, so streams are unchanged).
    s_plans, sols = [], []
    for name, placement, S, mode, count, wl, rng in cells:
        if cfg.plan_speeds is not None:
            s_plan = np.asarray(cfg.plan_speeds, dtype=np.float64)
        else:
            s_plan = np.maximum(
                rng.exponential(cfg.speed_mean, placement.n_machines), 1e-3)
        s_plans.append(s_plan)
        sols.append(solve_assignment(placement, s_plan, stragglers=S,
                                     lexicographic=False))

    # Phase 2 — ONE batched compile across every cell (placements and
    # tolerances may differ per cell).
    plans = compile_plan_batch(
        [c[1] for c in cells], sols, rows_per_tile=cfg.rows_per_tile,
        stragglers=[c[2] for c in cells], speeds=s_plans)

    # Phase 3 — per-cell scenario draws (continuing each cell's RNG).
    draws = []
    for (name, placement, S, mode, count, wl, rng), plan, s_plan in zip(
            cells, plans, s_plans):
        avail = [n for n in range(placement.n_machines)
                 if plan.n_valid[n] > 0]
        draws.append(draw_scenarios(
            s_plan, cfg.n_draws, cfg.jitter_sigma, rng, avail,
            n_stragglers=count, straggler_mode=mode))

    # Phase 4 — one stacked simulate per machine population.
    times_l: List[Optional[np.ndarray]] = [None] * len(cells)
    nstrag_l: List[Optional[np.ndarray]] = [None] * len(cells)
    by_n: Dict[int, List[int]] = {}
    for i, c in enumerate(cells):
        by_n.setdefault(c[1].n_machines, []).append(i)
    for _n, idxs in by_n.items():
        stack = PlanStack.from_batch([plans[i] for i in idxs])
        realized = np.concatenate([draws[i][0] for i in idxs], axis=0)
        drop = np.concatenate([draws[i][1] for i in idxs], axis=0)
        plan_index = np.repeat(np.arange(len(idxs), dtype=np.int64),
                               cfg.n_draws)
        timing = simulate_batch(stack, realized, dropped=drop,
                                plan_index=plan_index, on_infeasible="inf")
        for j, i in enumerate(idxs):
            sel = slice(j * cfg.n_draws, (j + 1) * cfg.n_draws)
            times_l[i] = timing.completion_times[sel]
            nstrag_l[i] = timing.n_straggled[sel]

    # Phase 5 — assemble (workload cost scaling exactly as sweep_cell).
    out: List[ScenarioResult] = []
    for i, (name, placement, S, mode, count, wl, rng) in enumerate(cells):
        times = times_l[i]
        c_star = sols[i].c_star
        scale = 1.0 if wl is None else float(wl.cost_scale())
        if scale != 1.0:
            times = times * scale
            c_star = c_star * scale
        out.append(ScenarioResult(
            name=name,
            placement=placement.name,
            tolerance=S,
            straggler_mode=mode,
            n_stragglers=count,
            completion_times=times,
            n_straggled=nstrag_l[i],
            c_star=c_star,
            workload="matvec" if wl is None else wl.name,
        ))
    return out


# ---------------------------------------------------------------------- #
# Churn sweep: availability traces with per-state plan memoization
# ---------------------------------------------------------------------- #
def sweep_churn(
    placement: Placement,
    events,
    cfg: SweepConfig = SweepConfig(),
    tolerance: int = 0,
    n_steps: Optional[int] = None,
    workload=None,
) -> ChurnSweepResult:
    """Deprecated shim: walk an availability trace and batch-evaluate every
    step. The churn walk now lives in
    :meth:`repro_torch.api.ElasticEngine.run` (``backend="simulate"``); this
    wrapper translates the legacy (SweepConfig, tolerance) calling
    convention and returns the same :class:`ChurnSweepResult` bit for bit.

    Args:
      placement: the storage placement (fixed across the run, as in USEC).
      events: iterable of :class:`repro_torch.core.elastic.ElasticEvent` (e.g. a
        :class:`MarkovChurnTrace` stepped externally, or
        :func:`scripted_trace`). Consumed up to ``n_steps`` items.
      cfg: sweep knobs (draws per step, jitter, planner speeds).
      tolerance: straggler tolerance S of every plan.
      n_steps: cap when ``events`` is an infinite generator.
      workload: optional :class:`repro_torch.api.Workload` whose ``cost_scale()``
        scales the analytical times (None = matvec, scale 1).

    Plans are memoized per availability set — elastic traces revisit states,
    and the planner is deterministic given (availability, plan speeds). All
    (step, draw) scenarios are evaluated by ONE `simulate_batch` call on the
    stacked plans.
    """
    import warnings

    from repro_torch.api import ElasticEngine, EngineConfig, MatVec, Policy

    warnings.warn(
        "sweep_churn is deprecated; use repro_torch.api.ElasticEngine("
        "..., backend='simulate').run(events=...)",
        DeprecationWarning, stacklevel=2,
    )
    engine = ElasticEngine(
        workload if workload is not None else MatVec(),
        Policy(stragglers=int(tolerance)),
        EngineConfig(
            rows_per_tile=cfg.rows_per_tile,
            seed=cfg.seed,
            n_draws=cfg.n_draws,
            speed_mean=cfg.speed_mean,
            jitter_sigma=cfg.jitter_sigma,
            plan_speeds=cfg.plan_speeds,
        ),
        backend="simulate",
        placement=placement,
    )
    res = engine.run(events=events, n_steps=n_steps)
    return ChurnSweepResult(res.steps, res.completion_times, res.total_waste)
