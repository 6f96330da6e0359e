"""Pre-vectorization reference implementations — the differential-test oracle.

These are verbatim copies of the scalar/Python-loop planning code paths as
they existed before the batched scenario engine vectorized them
(``fill_assignment``, ``compile_plan``, ``CompiledPlan.loads`` and
``CompiledPlan.include_mask``). They are kept solely so the property suite
can assert the vectorized versions are **bitwise identical** on randomized
instances: every float op happens in the same order with the same operands,
so equality is exact, not approximate.

Do not "optimize" this module — its value is that it does not change.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .assignment import AssignmentSolution
from .filling import TileAssignment, _ZERO
from .placement import Placement
from .plan import CompiledPlan, Segment, integerize_fractions


def fill_assignment_reference(
    mu_g: Sequence[float],
    machines: Sequence[int],
    stragglers: int = 0,
) -> TileAssignment:
    """Algorithm 2, original per-element loop form."""
    m = np.asarray(mu_g, dtype=np.float64).copy()
    ids = list(machines)
    if m.ndim != 1 or len(ids) != m.size:
        raise ValueError("mu_g and machines must align")
    L = 1 + int(stragglers)
    total = float(m.sum())
    if abs(total - L) > 1e-6:
        raise ValueError(f"sum(mu_g) = {total} != 1+S = {L}")
    if np.any(m < -_ZERO) or np.any(m > 1 + 1e-9):
        raise ValueError("mu_g entries must lie in [0, 1]")
    m = np.clip(m, 0.0, 1.0)

    fractions: List[float] = []
    groups: List[Tuple[int, ...]] = []
    if m.max() > m.sum() / L + 1e-9:
        raise ValueError("filling precondition violated: max(mu_g) > (1+S)^{-1} sum")

    for _ in range(m.size + 1):
        nz = np.flatnonzero(m > _ZERO)
        if nz.size == 0:
            break
        n_prime = nz.size
        if n_prime < L:
            raise RuntimeError(
                f"filling failed: {n_prime} non-zero loads < group size {L}"
            )
        l_prime = float(m[nz].sum())
        order = nz[np.argsort(m[nz], kind="stable")]  # ascending
        group_idx = [order[0]] + list(order[n_prime - L + 1:]) if L > 1 else [order[0]]
        group_idx = list(dict.fromkeys(int(i) for i in group_idx))
        if len(group_idx) != L:  # pragma: no cover - only on degenerate ties
            raise RuntimeError("filling produced a malformed group")
        if n_prime >= L + 1:
            kth_largest_excl = float(m[order[n_prime - L]])
            alpha = min(l_prime / L - kth_largest_excl, float(m[order[0]]))
        else:
            alpha = float(m[order[0]])
        alpha = max(alpha, 0.0)
        if alpha <= _ZERO:
            m[order[0]] = 0.0
            continue
        for i in group_idx:
            m[i] -= alpha
        m[np.abs(m) < _ZERO] = 0.0
        fractions.append(alpha)
        groups.append(tuple(sorted(ids[i] for i in group_idx)))
    else:  # pragma: no cover
        raise RuntimeError("filling did not terminate within N_g iterations")

    fr = np.asarray(fractions)
    if abs(fr.sum() - 1.0) > 1e-7:
        raise RuntimeError(f"filling fractions sum to {fr.sum()}, expected 1")
    fr = fr / fr.sum()
    return TileAssignment(fr, tuple(groups))


def compile_plan_reference(
    placement: Placement,
    solution: AssignmentSolution,
    rows_per_tile: int,
    stragglers: int = 0,
    speeds=None,
    row_align: int = 1,
    t_max=None,
) -> CompiledPlan:
    """Original per-worker/per-slot loop packing of the padded plan arrays."""
    N = placement.n_machines
    avail = set(solution.machines)
    restricted = placement.restrict(sorted(avail))
    s = np.ones(N) if speeds is None else np.asarray(speeds, dtype=np.float64)

    segments: List[Segment] = []
    per_worker: List[List[int]] = [[] for _ in range(N)]
    for g, holders in enumerate(restricted.holders):
        hs = list(holders)
        mu_g = solution.mu[g, hs]
        ta = fill_assignment_reference(mu_g, hs, stragglers)
        sizes = integerize_fractions(ta.fractions, rows_per_tile, row_align)
        start = 0
        for f, (size, group) in enumerate(zip(sizes, ta.groups)):
            if size == 0:
                continue
            loads = solution.loads
            prio = tuple(
                sorted(group, key=lambda n: (loads[n] / s[n], n))
            )
            sid = len(segments)
            segments.append(Segment(g, start, int(size), tuple(group), prio))
            for n in group:
                per_worker[n].append(sid)
            start += int(size)
        if start != rows_per_tile:
            raise RuntimeError(f"tile {g}: assigned {start} != {rows_per_tile} rows")

    cap = max((len(x) for x in per_worker), default=0)
    if t_max is not None:
        if t_max < cap:
            raise ValueError(f"t_max={t_max} < required capacity {cap}")
        cap = t_max
    cap = max(cap, 1)

    seg_tile = np.full((N, cap), -1, dtype=np.int32)
    seg_start = np.zeros((N, cap), dtype=np.int32)
    seg_len = np.zeros((N, cap), dtype=np.int32)
    seg_id = np.full((N, cap), -1, dtype=np.int32)
    n_valid = np.zeros(N, dtype=np.int32)
    for n in range(N):
        for t, sid in enumerate(per_worker[n]):
            seg = segments[sid]
            seg_tile[n, t] = seg.tile
            seg_start[n, t] = seg.row_start
            seg_len[n, t] = seg.row_len
            seg_id[n, t] = sid
        n_valid[n] = len(per_worker[n])

    return CompiledPlan(
        n_machines=N,
        rows_per_tile=rows_per_tile,
        stragglers=stragglers,
        segments=segments,
        seg_tile=seg_tile,
        seg_start=seg_start,
        seg_len=seg_len,
        seg_id=seg_id,
        n_valid=n_valid,
    )


def compile_plan_batch_reference(
    placements,
    solutions: Sequence[AssignmentSolution],
    rows_per_tile: int,
    stragglers=0,
    speeds=None,
    row_align: int = 1,
    t_max=None,
) -> List[CompiledPlan]:
    """Loop form of ``compile_plan_batch``: map the scalar reference compiler
    over the stack, one membership at a time. The batched compiler must be
    bitwise-identical to this (property-tested), exactly as the scalar
    vectorized paths are bit-checked against their loop forms above."""
    B = len(solutions)
    if isinstance(placements, Placement):
        placements = [placements] * B
    strag = (
        [int(stragglers)] * B if np.isscalar(stragglers)
        else [int(s) for s in stragglers]
    )
    if speeds is None:
        speeds_l = [None] * B
    elif isinstance(speeds, np.ndarray) and speeds.ndim == 1:
        speeds_l = [speeds] * B
    elif isinstance(speeds, (list, tuple)) and speeds and np.isscalar(speeds[0]):
        speeds_l = [np.asarray(speeds, dtype=np.float64)] * B
    else:
        speeds_l = list(speeds)
    return [
        compile_plan_reference(
            placements[b], solutions[b], rows_per_tile,
            stragglers=strag[b], speeds=speeds_l[b], row_align=row_align,
            t_max=t_max,
        )
        for b in range(B)
    ]


def loads_reference(plan: CompiledPlan) -> np.ndarray:
    """Original per-segment accumulation of per-machine loads."""
    out = np.zeros(plan.n_machines)
    for seg in plan.segments:
        for n in seg.group:
            out[n] += seg.row_len / plan.rows_per_tile
    return out


def include_mask_reference(
    plan: CompiledPlan, stragglers: Sequence[int] = ()
) -> np.ndarray:
    """Original winner-per-segment loop over all (worker, slot) pairs."""
    bad = set(int(x) for x in stragglers)
    mask = np.zeros(plan.seg_tile.shape, dtype=np.float32)
    winner: Dict[int, int] = {}
    for sid, seg in enumerate(plan.segments):
        w = next((n for n in seg.priority if n not in bad), None)
        if w is None:
            raise RuntimeError(
                f"segment {sid} (tile {seg.tile}) lost all of {seg.priority}; "
                f"straggler set {sorted(bad)} exceeds tolerance S={plan.stragglers}"
            )
        winner[sid] = w
    for n in range(plan.n_machines):
        for t in range(plan.t_max):
            sid = int(plan.seg_id[n, t])
            if sid >= 0 and winner.get(sid) == n:
                mask[n, t] = 1.0
    return mask
