"""Exact solver for the USEC computation-assignment problems (paper eqs. (6), (8)).

Problem (8) — the straggler-tolerant relaxation (eq. (6) is the S=0 case):

    minimize   c(M) = max_n ( sum_g mu[g, n] ) / s[n]
    subject to sum_{n : X_g in Z_n} mu[g, n] = 1 + S      for all g
               mu[g, n] = 0                               if X_g not in Z_n
               0 <= mu[g, n] <= 1

The paper solves this with a generic convex solver; we solve it **exactly**
with combinatorial tools, which is faster, dependency-free and certifiable:

1. *Feasibility oracle.* For a fixed completion time ``c``, feasibility is a
   transportation problem (max-flow): source →(1+S)→ g →(1)→ n →(cap_n)→ sink
   with cap_n = c·s[n].
2. *Discrete Newton (Dinkelbach) iteration* on the max-cut-ratio. The min
   cut of an infeasible evaluation identifies a bottleneck pair (A ⊆ tiles,
   B ⊆ machines) whose LP-duality ratio

       c* = [ (1+S)|A| − |E(A, N∖B)| − frozen_cap(B) ] / s(B ∩ unfrozen)

   is a strictly larger lower bound on the optimum; re-evaluating at that
   ratio either certifies it feasible (then it *is* the exact optimum) or
   yields the next violated cut. Convergence takes as many max-flow calls
   as there are distinct binding cuts on the trajectory — typically 2–4,
   versus the ~60 of the bisection this replaced (the replan hot path's
   dominant cost; see docs/architecture.md "performance model").
3. *Bisection fallback.* Any numerical degeneracy in the Newton iteration
   (non-increasing ratio, cut above the known-feasible bracket) falls back
   to plain bisection plus one min-cut refinement at the infeasible end —
   the pre-Newton code path, kept verbatim. Either way feasibility is
   verified at c* before adopting, so the result is exact, not approximate.
4. *Lexicographic (max-min fair) leveling.* The min-max optimum is not unique
   below the max; the paper's reported solutions (e.g. Fig. 3's
   μ* = [2,2,2,3,3]) are the balanced ones. Any min cut at the optimum is
   *saturated in every optimal solution*, so we freeze the cut machines at
   capacity ``c_r · s[n]`` and re-minimize the max over the remaining
   machines, repeating until all are frozen. This yields the unique
   lexicographically-minimal sorted load/speed vector.

The returned ``mu`` satisfies the filling-algorithm precondition
``max_n mu[g, n] <= 1`` via the box constraint.

``scipy.optimize.linprog`` is used only in tests, as an independent oracle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .maxflow import transportation_feasible
from .placement import Placement

_BISECT_ITERS = 60
_NEWTON_ITERS = 24


@dataclass
class AssignmentSolution:
    """Optimal fractional computation assignment for one time step.

    Attributes:
      c_star: optimal computation time (paper's c*(M)).
      mu: (G, N) computation-load matrix; mu[g, n] in [0, 1]; rows sum to 1+S
        over the available holders of g and are 0 elsewhere. Loads are the
        lexicographically-minimal optimal solution (max-min fair).
      machines: the available machine ids (global indices). Columns of
        preempted machines are all-zero.
      loads: (N,) per-machine total load sum_g mu[g, n].
      bottleneck_tiles / bottleneck_machines: the first-round min-cut
        certificate (A, B) whose ratio equals c_star (B = all available
        machines when c_star equals the perfect-balance bound).
    """

    c_star: float
    mu: np.ndarray
    machines: Tuple[int, ...]
    loads: np.ndarray
    bottleneck_tiles: Tuple[int, ...]
    bottleneck_machines: Tuple[int, ...]

    def time_of(self, speeds: np.ndarray) -> float:
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.where(self.loads > 0, self.loads / np.maximum(speeds, 1e-300), 0.0)
        return float(np.max(t)) if t.size else 0.0


def solve_assignment(
    placement: Placement,
    speeds: Sequence[float],
    available: Optional[Sequence[int]] = None,
    stragglers: int = 0,
    lexicographic: bool = True,
    lex_rounds: int = 12,
) -> AssignmentSolution:
    """Solve problem (8) (or (6) when ``stragglers == 0``) exactly.

    Args:
      placement: the uncoded storage placement Z (over all N machines).
      speeds: length-N strictly positive speed vector s (entries for
        preempted machines are ignored).
      available: machine ids in N_t; defaults to all N machines.
      stragglers: S, the number of stragglers to tolerate. Requires the
        restricted placement to keep >= 1+S holders per tile.
      lexicographic: balance loads below the optimal max (paper's reported
        solutions). c_star is identical either way; disable for a faster
        single-round solve when only c* and *a* witness are needed.
      lex_rounds: cap on leveling rounds (the first round always computes the
        exact c*; later rounds only improve balance below the max).
    """
    N = placement.n_machines
    s_full = np.asarray(speeds, dtype=np.float64)
    if s_full.shape != (N,):
        raise ValueError(f"speeds must have shape ({N},), got {s_full.shape}")
    avail: Tuple[int, ...] = (
        tuple(range(N)) if available is None else tuple(sorted(int(a) for a in available))
    )
    if np.any(s_full[list(avail)] <= 0):
        raise ValueError("speeds of available machines must be strictly positive")

    restricted = placement.restrict(avail)
    S = int(stragglers)
    if S < 0:
        raise ValueError("stragglers must be >= 0")
    need = 1.0 + S
    for g, hs in enumerate(restricted.holders):
        if len(hs) < need:
            raise ValueError(
                f"tile {g} has {len(hs)} available holders < 1+S={int(need)}; "
                "straggler tolerance infeasible under this placement/availability"
            )

    G = restricted.n_tiles
    edges = restricted.edges()  # (g, n) with n a *global* machine index
    holder_mask = restricted.holder_matrix()  # (G, N) bool, reused throughout
    supply = np.full(G, need)
    need_total = need * G
    tol = 1e-9 * max(1.0, need_total)

    def feasible_with_caps(node_cap: np.ndarray):
        return transportation_feasible(supply, node_cap, edges, edge_cap=1.0, tol=tol)

    # Frozen capacities as a dense array (NaN = unfrozen) so per-candidate
    # cap vectors are one vectorized select, not a Python loop over machines.
    avail_arr = np.asarray(avail, dtype=np.int64)
    frozen_arr = np.full(N, np.nan)

    def caps_for(c: float) -> np.ndarray:
        node_cap = np.zeros(N)
        fv = frozen_arr[avail_arr]
        node_cap[avail_arr] = np.where(
            np.isnan(fv), c * s_full[avail_arr], fv)
        return node_cap

    # ------------------------------------------------------------------ #
    # Lexicographic rounds: each round minimizes max load/speed over the
    # still-unfrozen machines, then freezes the binding min-cut machines.
    # ------------------------------------------------------------------ #
    unfrozen: Set[int] = set(avail)
    c_star: Optional[float] = None
    first_cut_tiles: Tuple[int, ...] = ()
    first_cut_machines: Tuple[int, ...] = ()
    mu_star = np.zeros((G, N))

    # Global upper bound: every machine computes everything it stores.
    stored_counts = holder_mask.sum(axis=0)
    c_hi0 = float(np.max(need * stored_counts[avail_arr] / s_full[avail_arr])) + 1e-12

    def _cut_of(flownet) -> Tuple[List[int], List[int], List[int]]:
        reach = flownet.min_cut_reachable(G + N)  # source node index
        A = [g for g in range(G) if reach[g]]
        B = [n for n in avail if reach[G + n]]
        B_un = [n for n in B if n in unfrozen]
        return A, B, B_un

    def _newton_round(flow_lo, c_hi: float):
        """Discrete Newton on the max-cut-ratio.

        ``flow_lo`` is the residual network of an *infeasible* evaluation;
        its min cut is violated there, so the cut's duality ratio strictly
        exceeds the evaluation point while never exceeding the round
        optimum. Re-evaluating at the ratio either certifies it (feasible
        => it IS the exact optimum) or hands back the next violated cut.
        Returns (c_round, mu, A, B, B_un) or None on degeneracy (caller
        falls back to bisection).
        """
        flow, c = flow_lo, 0.0
        for _ in range(_NEWTON_ITERS):
            A, B, B_un = _cut_of(flow)
            r = _cut_ratio(holder_mask, s_full, A, B, B_un, frozen_arr, need)
            if r is None or r <= c or r > c_hi * (1 + 1e-9):
                return None
            ok, mu, flow2, _ = feasible_with_caps(
                caps_for(r * (1 + 1e-12) + 1e-15))
            if ok:
                return r, mu, A, B, B_un
            c, flow = r, flow2
        return None

    c_prev = c_hi0
    max_rounds = max(1, int(lex_rounds)) if lexicographic else 1
    for _round in range(max_rounds + 1):
        if not unfrozen:
            break
        if _round == max_rounds:
            # Round budget exhausted: freeze the remainder at the last level.
            # c_star (round 1) is already exact; only balance is truncated.
            for n in list(unfrozen):
                frozen_arr[n] = c_prev * s_full[n]
            unfrozen.clear()
            break
        # Feasibility at c = 0 for unfrozen -> they can all idle; freeze at 0.
        ok0, mu0, flow0, _ = feasible_with_caps(caps_for(0.0))
        if ok0:
            for n in unfrozen:
                frozen_arr[n] = 0.0
            mu_star = mu0
            if c_star is None:
                c_star = 0.0
            break

        newton = _newton_round(flow0, c_prev)
        if newton is not None:
            c_round, mu_best, A, B, B_un = newton
        else:
            # Bisection fallback (the pre-Newton path, kept verbatim):
            # warm-started bracket — levels are non-increasing across rounds.
            lo, hi = 0.0, c_prev * (1 + 1e-12) + 1e-15
            ok_hi, mu_hi, _, _ = feasible_with_caps(caps_for(hi))
            if not ok_hi:  # pragma: no cover - hi is feasible by construction
                raise RuntimeError("internal error: upper bracket infeasible")
            mu_best = mu_hi
            iters = _BISECT_ITERS if _round == 0 else 40
            for _ in range(iters):
                mid = 0.5 * (lo + hi)
                ok, mu_mid, _, _ = feasible_with_caps(caps_for(mid))
                if ok:
                    hi, mu_best = mid, mu_mid
                else:
                    lo = mid

            # Min-cut at the infeasible end certifies the exact round optimum.
            _, _, dinic, _ = feasible_with_caps(caps_for(lo))
            A, B, B_un = _cut_of(dinic)
            c_round = hi
            c_exact = _cut_ratio(holder_mask, s_full, A, B, B_un,
                                 frozen_arr, need)
            if (
                c_exact is not None
                and lo - tol <= c_exact <= hi + 1e-6 * max(1.0, hi)
            ):
                ok, mu_exact, _, _ = feasible_with_caps(
                    caps_for(c_exact * (1 + 1e-12) + 1e-15)
                )
                if ok:
                    c_round, mu_best = c_exact, mu_exact
        mu_star = mu_best

        if c_star is None:
            c_star = c_round
            first_cut_tiles = tuple(A)
            first_cut_machines = tuple(B) if B else tuple(avail)

        if not lexicographic:
            break
        # Freeze only the *certified* saturated machines (any min cut is
        # saturated in every optimal solution; witness loads are not a
        # certificate). Fall back to the max-loaded machines if the cut is
        # degenerate.
        to_freeze = set(B_un)
        if not to_freeze:
            loads_now = mu_best.sum(axis=0)
            rel = np.array(
                [loads_now[n] / s_full[n] if n in unfrozen else -np.inf for n in range(N)]
            )
            mmax = rel.max()
            to_freeze = {n for n in unfrozen if rel[n] >= mmax - 1e-9}
        for n in to_freeze:
            frozen_arr[n] = c_round * s_full[n]
            unfrozen.discard(n)
        c_prev = c_round

    assert c_star is not None

    # Clean numerical dust and re-normalize rows exactly to 1+S.
    mu_star[mu_star < 1e-12] = 0.0
    np.clip(mu_star, 0.0, 1.0, out=mu_star)
    mu_star[~holder_mask] = 0.0
    row = mu_star.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(row > 0, need / np.maximum(row, 1e-300), 1.0)
    mu_star = mu_star * scale[:, None]
    for g in range(G):
        _repair_row(mu_star[g], holder_mask[g], need)

    loads = mu_star.sum(axis=0)
    return AssignmentSolution(
        c_star=float(c_star),
        mu=mu_star,
        machines=avail,
        loads=loads,
        bottleneck_tiles=first_cut_tiles,
        bottleneck_machines=first_cut_machines,
    )


def _repair_row(row: np.ndarray, mask: np.ndarray, need: float) -> None:
    """Clamp a row to [0,1] on holders and redistribute so it sums to need."""
    row[~mask] = 0.0
    for _ in range(row.size + 1):
        np.clip(row, 0.0, 1.0, out=row)
        deficit = need - row.sum()
        if abs(deficit) < 1e-12:
            return
        if deficit > 0:
            free = mask & (row < 1.0 - 1e-15)
            headroom = np.where(free, 1.0 - row, 0.0)
            total = headroom.sum()
            if total <= 0:
                raise RuntimeError("row repair impossible: all holders capped")
            row += headroom * (deficit / total)
        else:
            pos = row > 0
            weight = np.where(pos, row, 0.0)
            row += weight * (deficit / weight.sum())


def _cut_ratio(
    holder_mask: np.ndarray,
    speeds: np.ndarray,
    tiles: List[int],
    machines_B: List[int],
    machines_B_unfrozen: List[int],
    frozen_arr: np.ndarray,
    need: float,
) -> Optional[float]:
    """Duality ratio  [need·|A| − |E(A, N∖B)| − frozen_cap(B∩frozen)] / s(B∩unfrozen).

    ``frozen_arr`` is the (N,) frozen-capacity vector, NaN on unfrozen
    machines (the solver's single source of truth for frozen state).
    """
    if not machines_B_unfrozen:
        return None
    in_B = np.zeros(holder_mask.shape[1], dtype=bool)
    in_B[machines_B] = True
    e_out = int(holder_mask[tiles][:, ~in_B].sum())
    cap_frozen = float(np.nansum(frozen_arr[machines_B]))
    num = need * len(tiles) - e_out - cap_frozen
    den = float(np.sum(speeds[machines_B_unfrozen]))
    if den <= 0 or num <= 0:
        return None
    return num / den


def lower_bound(
    placement: Placement,
    speeds: Sequence[float],
    available: Optional[Sequence[int]] = None,
    stragglers: int = 0,
) -> float:
    """Perfect-balance lower bound (1+S)G / s(N_t) (ignores storage locality)."""
    N = placement.n_machines
    avail = tuple(range(N)) if available is None else tuple(available)
    s = np.asarray(speeds, dtype=np.float64)
    return (1.0 + stragglers) * placement.n_tiles / float(np.sum(s[list(avail)]))
