"""Turn fractional USEC assignments into executable, padded tile plans.

The planning pipeline per time step is

    Placement  +  speeds  --(assignment.py LP)-->  mu*  --(filling.py)-->
    {alpha_{g,f}, P_{g,f}}  --(this module)-->  CompiledPlan

A :class:`CompiledPlan` is plain integer/float arrays, padded to static shapes,
so the jitted executors never recompile when the plan changes (elasticity,
speed drift and straggler re-planning are *data*, not *code*).

Terminology: a *tile* is the unit of storage placement (the paper's
sub-matrix X_g — or a microbatch shard in training); a *segment* is a
contiguous row range of one tile assigned to a group of ``1 + S`` machines.

Row fractions are integerized by the largest-remainder method at a
configurable ``row_align`` granularity (TPU kernels want MXU-aligned block
boundaries; the paper's EC2 setting uses align=1).

The hot paths here (plan packing, winner masks, coverage checks, loads) are
vectorized NumPy; :mod:`repro_torch.core.reference` keeps the original loop forms
as the differential-testing oracle, and the property suite asserts bitwise
identity between the two on randomized instances.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .assignment import AssignmentSolution
from .filling import TileAssignment, fill_assignment, fill_assignment_batch
from .placement import Placement


@dataclass(frozen=True)
class Segment:
    """A contiguous row range of one tile, computed by ``1+S`` machines."""

    tile: int
    row_start: int  # within the tile
    row_len: int
    group: Tuple[int, ...]      # machines computing this segment
    priority: Tuple[int, ...]   # same machines, combine-priority order


@dataclass
class CompiledPlan:
    """Padded per-worker arrays consumed by the jitted executors.

    All arrays are over *global machine slots* [0, N): preempted machines are
    simply workers with ``n_valid == 0``. ``T_max`` is the static per-worker
    segment capacity (max over workers, padded).

    seg_tile/(seg_start, seg_len): which rows of which tile slot ``t`` of
      worker ``n`` computes; pads have len 0 and tile -1.
    n_valid: per-worker live segment count (drives per-worker loop bounds).

    Per-*segment* views (``seg_group``, ``seg_priority``, ...) are derived
    lazily and cached — they are what the batched simulator consumes.
    """

    n_machines: int
    rows_per_tile: int
    stragglers: int
    segments: List[Segment]
    seg_tile: np.ndarray     # (N, T_max) int32
    seg_start: np.ndarray    # (N, T_max) int32
    seg_len: np.ndarray      # (N, T_max) int32
    seg_id: np.ndarray       # (N, T_max) int32  -> index into ``segments``
    n_valid: np.ndarray      # (N,) int32

    def __post_init__(self):
        self._derived: Optional[Tuple[np.ndarray, ...]] = None
        self._loads: Optional[np.ndarray] = None

    @property
    def t_max(self) -> int:
        return self.seg_tile.shape[1]

    @property
    def n_segments(self) -> int:
        return len(self.segments)

    # ------------------------------------------------------------------ #
    # Per-segment array views (cached; the batch simulator's input)
    # ------------------------------------------------------------------ #
    def seg_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(tile_of, start_of, len_of, group, priority) per-segment arrays.

        ``group`` and ``priority`` are (n_seg, 1+S) int32; the rest (n_seg,)
        int32. Computed once per plan.
        """
        if self._derived is None:
            L = 1 + self.stragglers
            n_seg = len(self.segments)
            if n_seg:
                tile_of = np.fromiter(
                    (s.tile for s in self.segments), np.int32, n_seg)
                start_of = np.fromiter(
                    (s.row_start for s in self.segments), np.int32, n_seg)
                len_of = np.fromiter(
                    (s.row_len for s in self.segments), np.int32, n_seg)
                group = np.asarray(
                    [s.group for s in self.segments], np.int32).reshape(n_seg, L)
                prio = np.asarray(
                    [s.priority for s in self.segments], np.int32).reshape(n_seg, L)
            else:
                tile_of = start_of = len_of = np.zeros(0, np.int32)
                group = prio = np.zeros((0, L), np.int32)
            self._derived = (tile_of, start_of, len_of, group, prio)
        return self._derived

    def loads(self) -> np.ndarray:
        """Per-machine assigned load in tile units (sum of row fractions)."""
        if self._loads is None:
            _, _, len_of, group, _ = self.seg_arrays()
            out = np.zeros(self.n_machines)
            if len(self.segments):
                L = group.shape[1]
                contrib = len_of.astype(np.float64) / self.rows_per_tile
                np.add.at(out, group.ravel(), np.repeat(contrib, L))
            self._loads = out
        return self._loads.copy()

    def include_mask(self, stragglers: Sequence[int] = ()) -> np.ndarray:
        """(N, T_max) float32: 1.0 where this worker's copy of the segment is
        the one the combiner uses, given the realized straggler set.

        Emulates the paper's master semantics — for every segment the result
        comes from the highest-priority *non-straggler* group member (the
        paper's "first arrival"; our priority order is fastest-finisher-first).
        Raises if all ``1+S+`` holders of some segment straggled (more
        stragglers than the plan tolerates).
        """
        tile_of, _, _, _, prio = self.seg_arrays()
        n_seg = len(self.segments)
        bad = np.zeros(self.n_machines, dtype=bool)
        # Ids outside [0, N) are ignored, matching the original set-based
        # membership test (e.g. -1 pad sentinels leaking from id arrays).
        sid_arr = np.asarray([int(x) for x in stragglers], dtype=np.int64)
        bad[sid_arr[(sid_arr >= 0) & (sid_arr < self.n_machines)]] = True
        if n_seg == 0:
            return np.zeros(self.seg_tile.shape, dtype=np.float32)
        ok = ~bad[prio]                      # (n_seg, L)
        alive = ok.any(axis=1)
        if not alive.all():
            sid = int(np.argmin(alive))
            seg = self.segments[sid]
            raise RuntimeError(
                f"segment {sid} (tile {seg.tile}) lost all of {seg.priority}; "
                f"straggler set {sorted(np.flatnonzero(bad).tolist())} "
                f"exceeds tolerance S={self.stragglers}"
            )
        winner = prio[np.arange(n_seg), ok.argmax(axis=1)]   # (n_seg,)
        valid = self.seg_id >= 0
        w = winner[np.clip(self.seg_id, 0, None)]
        mask = (valid & (w == np.arange(self.n_machines)[:, None]))
        return mask.astype(np.float32)

    def rows_of(self, machine: int) -> Set[int]:
        """Global row ids (tile * rows_per_tile + r) machine computes."""
        tile_of, start_of, len_of, group, _ = self.seg_arrays()
        if not len(self.segments):
            return set()
        member = (group == int(machine)).any(axis=1)
        base = tile_of[member].astype(np.int64) * self.rows_per_tile \
            + start_of[member]
        out: Set[int] = set()
        for b, ln in zip(base.tolist(), len_of[member].tolist()):
            out.update(range(b, b + ln))
        return out


def integerize_fractions(
    fractions: np.ndarray, rows: int, align: int = 1
) -> np.ndarray:
    """Largest-remainder split of ``rows`` into len(fractions) integer sizes.

    With ``align > 1`` the split happens in units of ``align`` rows and the
    remainder rows go to the largest fraction (kernel-friendly boundaries).
    """
    f = np.asarray(fractions, dtype=np.float64)
    if abs(f.sum() - 1.0) > 1e-6:
        raise ValueError("fractions must sum to 1")
    units = rows // align
    rem = rows - units * align
    raw = f * units
    base = np.floor(raw).astype(np.int64)
    short = units - int(base.sum())
    if short > 0:
        order = np.argsort(-(raw - base), kind="stable")
        base[order[:short]] += 1
    sizes = base * align
    if rem > 0:
        # Tail remainder goes to the LAST non-empty part so every segment
        # start stays align-multiple (kernel-friendly boundaries).
        nz = np.flatnonzero(sizes)
        idx = int(nz[-1]) if nz.size else int(np.argmax(f))
        sizes[idx] += rem
    assert sizes.sum() == rows
    return sizes


def _integerize_batch(
    fr_rows: Sequence[np.ndarray], rows: int, align: int
) -> List[np.ndarray]:
    """:func:`integerize_fractions` over a stack of fraction vectors.

    Instances are grouped by part count so each group is one vectorized
    largest-remainder pass; bitwise-identical to the scalar function per
    instance (floor/multiply are elementwise, the tie-break argsort is the
    same stable sort per row, and all size arithmetic is integer-exact).
    """
    out: List[Optional[np.ndarray]] = [None] * len(fr_rows)
    parts = np.asarray([len(f) for f in fr_rows], dtype=np.int64)
    units = rows // align
    rem = rows - units * align
    for F in np.unique(parts):
        F = int(F)
        idxs = np.flatnonzero(parts == F)
        f = np.stack([np.asarray(fr_rows[i], dtype=np.float64) for i in idxs])
        ssum = f.sum(axis=1)
        if np.any(np.abs(ssum - 1.0) > 1e-6):
            raise ValueError("fractions must sum to 1")
        raw = f * units
        base = np.floor(raw).astype(np.int64)
        short = units - base.sum(axis=1)
        order = np.argsort(-(raw - base), axis=1, kind="stable")
        rank = np.empty_like(order)
        np.put_along_axis(
            rank, order,
            np.broadcast_to(np.arange(F, dtype=np.int64), order.shape),
            axis=1)
        base += rank < short[:, None]
        sizes = base * align
        if rem > 0:
            # Tail remainder goes to the LAST non-empty part so every
            # segment start stays align-multiple (kernel-friendly
            # boundaries) — same rule as the scalar path.
            nz = sizes > 0
            lastnz = F - 1 - np.argmax(nz[:, ::-1], axis=1)
            idx = np.where(nz.any(axis=1), lastnz, np.argmax(f, axis=1))
            sizes[np.arange(len(idxs)), idx] += rem
        assert np.all(sizes.sum(axis=1) == rows)
        for r, i in enumerate(idxs):
            out[i] = sizes[r]
    return out  # type: ignore[return-value]


def compile_plan_batch(
    placements,
    solutions: Sequence[AssignmentSolution],
    rows_per_tile: int,
    stragglers=0,
    speeds=None,
    row_align: int = 1,
    t_max: Optional[int] = None,
) -> List[CompiledPlan]:
    """Compile plans for a *stack* of memberships/speed-vectors at once.

    The batched membership-space plan compiler: every (plan, tile) pair
    becomes one instance of :func:`~repro_torch.core.filling.fill_assignment_batch`
    (a single vectorized greedy peel for the whole stack), fraction
    integerization runs through :func:`_integerize_batch`, combine
    priorities are sorted in one pass per group width, and the padded
    per-worker arrays come from the same :func:`_pack_segments` the scalar
    compiler uses. The result is **bitwise identical** to
    ``[compile_plan(p_b, sol_b, ...) for b in range(B)]`` — asserted by the
    property suite against the scalar path (which is itself bit-checked
    against :mod:`repro_torch.core.reference`).

    Args:
      placements: one :class:`Placement` shared by every solution, or a
        sequence of per-solution placements (they may differ in machine
        population — a sweep-grid batch).
      solutions: the per-membership LP solutions.
      rows_per_tile / row_align / t_max: as :func:`compile_plan` (shared by
        the whole batch — one static shape family).
      stragglers: S, an int or a per-solution sequence.
      speeds: combine-priority speeds — None (machine-id order), one (N,)
        vector shared by all, or a per-solution sequence of vectors.
    """
    B = len(solutions)
    if B == 0:
        return []
    if isinstance(placements, Placement):
        placements = [placements] * B
    if len(placements) != B:
        raise ValueError("placements and solutions must align")
    strag = (
        [int(stragglers)] * B if np.isscalar(stragglers)
        else [int(s) for s in stragglers]
    )
    if len(strag) != B:
        raise ValueError("stragglers must be an int or length-B sequence")
    if speeds is None:
        speeds_l = [np.ones(p.n_machines) for p in placements]
    elif isinstance(speeds, np.ndarray) and speeds.ndim == 1:
        speeds_l = [np.asarray(speeds, dtype=np.float64)] * B
    elif isinstance(speeds, (list, tuple)) and speeds and np.isscalar(speeds[0]):
        speeds_l = [np.asarray(speeds, dtype=np.float64)] * B
    else:
        speeds_l = [np.asarray(s, dtype=np.float64) for s in speeds]
    if len(speeds_l) != B:
        raise ValueError("speeds must be None, one vector, or length-B")

    # ---------------------------------------------------------------- #
    # Assemble (plan, tile) instances and run ONE batched fill.
    # ---------------------------------------------------------------- #
    finish = []
    inst_mu: List[np.ndarray] = []
    inst_ids: List[List[int]] = []
    inst_S: List[int] = []
    inst_of: List[Tuple[int, int]] = []       # instance -> (plan, tile)
    for b, (placement, sol) in enumerate(zip(placements, solutions)):
        avail = set(sol.machines)
        restricted = placement.restrict(sorted(avail))
        s = speeds_l[b]
        with np.errstate(divide="ignore", invalid="ignore"):
            finish.append(sol.loads / s)
        for g, holders in enumerate(restricted.holders):
            hs = list(holders)
            inst_mu.append(sol.mu[g, hs])
            inst_ids.append(hs)
            inst_S.append(strag[b])
            inst_of.append((b, g))
    tas = fill_assignment_batch(inst_mu, inst_ids, inst_S)
    sizes_l = _integerize_batch(
        [ta.fractions for ta in tas], rows_per_tile, row_align)

    # ---------------------------------------------------------------- #
    # Combine priorities in one stable argsort per group width.
    # ---------------------------------------------------------------- #
    kept_gm: List[Optional[np.ndarray]] = [None] * len(tas)
    kept_prio: List[Optional[np.ndarray]] = [None] * len(tas)
    by_width: Dict[int, List[int]] = {}
    for i, ta in enumerate(tas):
        keep = np.flatnonzero(sizes_l[i])
        if keep.size == 0:  # pragma: no cover - rows_per_tile >= 1
            continue
        kept_gm[i] = ta.group_matrix()[keep]
        by_width.setdefault(1 + inst_S[i], []).append(i)
    for width, idxs in by_width.items():
        gm_all = np.concatenate([kept_gm[i] for i in idxs], axis=0)
        b_of = np.concatenate([
            np.full(kept_gm[i].shape[0], inst_of[i][0], dtype=np.int64)
            for i in idxs
        ])
        n_max = max(speeds_l[b].shape[0] for b in set(b_of.tolist()))
        fr_pad = np.zeros((B, n_max))
        for b in set(b_of.tolist()):
            fr_pad[b, : finish[b].shape[0]] = finish[b]
        ratio = fr_pad[b_of[:, None], gm_all]
        # Priority = sorted by (expected finish ratio, machine id): rows of
        # gm are ascending machine ids, so a stable argsort on the ratio
        # alone breaks ties by id exactly like the scalar compiler.
        order = np.argsort(ratio, axis=1, kind="stable")
        prio_all = np.take_along_axis(gm_all, order, axis=1)
        off = 0
        for i in idxs:
            k = kept_gm[i].shape[0]
            kept_prio[i] = prio_all[off: off + k]
            off += k

    # ---------------------------------------------------------------- #
    # Emit segments per plan and pack with the shared packer.
    # ---------------------------------------------------------------- #
    inst_by_plan: List[List[int]] = [[] for _ in range(B)]
    for i, (b, _g) in enumerate(inst_of):
        inst_by_plan[b].append(i)
    plans: List[CompiledPlan] = []
    for b in range(B):
        N = placements[b].n_machines
        L = 1 + strag[b]
        segments: List[Segment] = []
        group_rows: List[np.ndarray] = []
        for i in inst_by_plan[b]:
            sizes = sizes_l[i]
            if int(sizes.sum()) != rows_per_tile:  # pragma: no cover
                raise RuntimeError(
                    f"tile {inst_of[i][1]}: assigned {sizes.sum()} != "
                    f"{rows_per_tile} rows")
            gm, prio = kept_gm[i], kept_prio[i]
            if gm is None:
                continue
            g = inst_of[i][1]
            keep = np.flatnonzero(sizes)
            starts = np.cumsum(sizes) - sizes
            for row, f in enumerate(keep.tolist()):
                segments.append(Segment(
                    g, int(starts[f]), int(sizes[f]),
                    tuple(gm[row].tolist()), tuple(prio[row].tolist()),
                ))
            group_rows.append(gm)
        n_seg = len(segments)
        if n_seg:
            group_all = np.concatenate(group_rows, axis=0)
            tile_of = np.fromiter(
                (s_.tile for s_ in segments), np.int32, n_seg)
            start_of = np.fromiter(
                (s_.row_start for s_ in segments), np.int32, n_seg)
            len_of = np.fromiter(
                (s_.row_len for s_ in segments), np.int32, n_seg)
        else:
            group_all = tile_of = start_of = len_of = None
        seg_tile, seg_start, seg_len, seg_id, counts = _pack_segments(
            placements[b].n_machines, group_all, tile_of, start_of, len_of,
            t_max)
        plan = CompiledPlan(
            n_machines=N,
            rows_per_tile=rows_per_tile,
            stragglers=strag[b],
            segments=segments,
            seg_tile=seg_tile,
            seg_start=seg_start,
            seg_len=seg_len,
            seg_id=seg_id,
            n_valid=counts.astype(np.int32),
        )
        if n_seg:
            prio_arr = np.asarray(
                [s_.priority for s_ in segments], np.int32).reshape(n_seg, L)
            plan._derived = (tile_of, start_of, len_of,
                             group_all.astype(np.int32), prio_arr)
        plans.append(plan)
    return plans


def _pack_segments(
    n_machines: int,
    group_all: Optional[np.ndarray],
    tile_of: Optional[np.ndarray],
    start_of: Optional[np.ndarray],
    len_of: Optional[np.ndarray],
    t_max: Optional[int],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized packing of per-segment arrays into padded (N, T) planes.

    Worker n's slots are its segments in sid order (a stable sort of the
    flattened membership list by worker). Shared by the scalar and batched
    compilers, so their packed arrays are identical by construction.
    Returns (seg_tile, seg_start, seg_len, seg_id, counts).
    """
    N = n_machines
    n_seg = 0 if group_all is None else group_all.shape[0]
    if n_seg:
        L = group_all.shape[1]
        flat_w = group_all.ravel().astype(np.int64)
        flat_sid = np.repeat(np.arange(n_seg, dtype=np.int64), L)
        order = np.argsort(flat_w, kind="stable")
        w_sorted = flat_w[order]
        sid_sorted = flat_sid[order]
        counts = np.bincount(flat_w, minlength=N)
        offsets = np.concatenate(([0], np.cumsum(counts)))[:-1]
        t_idx = np.arange(flat_w.size) - np.repeat(offsets, counts)
    else:
        w_sorted = sid_sorted = t_idx = np.zeros(0, np.int64)
        counts = np.zeros(N, np.int64)

    cap = int(counts.max()) if n_seg else 0
    if t_max is not None:
        if t_max < cap:
            raise ValueError(f"t_max={t_max} < required capacity {cap}")
        cap = t_max
    cap = max(cap, 1)

    seg_tile = np.full((N, cap), -1, dtype=np.int32)
    seg_start = np.zeros((N, cap), dtype=np.int32)
    seg_len = np.zeros((N, cap), dtype=np.int32)
    seg_id = np.full((N, cap), -1, dtype=np.int32)
    if n_seg:
        seg_tile[w_sorted, t_idx] = tile_of[sid_sorted]
        seg_start[w_sorted, t_idx] = start_of[sid_sorted]
        seg_len[w_sorted, t_idx] = len_of[sid_sorted]
        seg_id[w_sorted, t_idx] = sid_sorted.astype(np.int32)
    return seg_tile, seg_start, seg_len, seg_id, counts


def compile_plan(
    placement: Placement,
    solution: AssignmentSolution,
    rows_per_tile: int,
    stragglers: int = 0,
    speeds: Optional[Sequence[float]] = None,
    row_align: int = 1,
    t_max: Optional[int] = None,
) -> CompiledPlan:
    """Run the filling algorithm per tile and pack the padded plan arrays.

    Args:
      placement: the *full* placement (plan columns index global machines).
      solution: output of :func:`assignment.solve_assignment` (already
        restricted to the available machines).
      rows_per_tile: q/G — rows (or samples) per tile.
      stragglers: S.
      speeds: used only to order each group's combine priority
        (fastest-finisher first); defaults to machine-id order.
      row_align: integerization granularity.
      t_max: pad the per-worker segment capacity to at least this (lets a
        long-running job keep one static shape across re-plans).
    """
    N = placement.n_machines
    L = 1 + int(stragglers)
    avail = set(solution.machines)
    restricted = placement.restrict(sorted(avail))
    s = np.ones(N) if speeds is None else np.asarray(speeds, dtype=np.float64)
    loads = solution.loads
    with np.errstate(divide="ignore", invalid="ignore"):
        finish_ratio = loads / s   # combine-priority key, fastest first

    segments: List[Segment] = []
    group_rows: List[np.ndarray] = []
    for g, holders in enumerate(restricted.holders):
        hs = list(holders)
        mu_g = solution.mu[g, hs]
        ta: TileAssignment = fill_assignment(mu_g, hs, stragglers)
        sizes = integerize_fractions(ta.fractions, rows_per_tile, row_align)
        keep = np.flatnonzero(sizes)
        starts = np.concatenate(([0], np.cumsum(sizes)))[:-1]
        if int(sizes.sum()) != rows_per_tile:  # pragma: no cover
            raise RuntimeError(f"tile {g}: assigned {sizes.sum()} != {rows_per_tile} rows")
        if keep.size == 0:
            continue
        gm = ta.group_matrix()[keep]                  # (F_keep, L), rows sorted asc
        # Priority = sorted by (expected finish ratio, machine id): rows of gm
        # are ascending machine ids, so a stable argsort on the ratio alone
        # breaks ties by id exactly like the scalar sorted(key=(ratio, n)).
        order = np.argsort(finish_ratio[gm], axis=1, kind="stable")
        prio = np.take_along_axis(gm, order, axis=1)
        for i, f in enumerate(keep.tolist()):
            segments.append(Segment(
                g, int(starts[f]), int(sizes[f]),
                tuple(gm[i].tolist()), tuple(prio[i].tolist()),
            ))
        group_rows.append(gm)

    n_seg = len(segments)
    if n_seg:
        group_all = np.concatenate(group_rows, axis=0)     # (n_seg, L)
        tile_of = np.fromiter((s_.tile for s_ in segments), np.int32, n_seg)
        start_of = np.fromiter((s_.row_start for s_ in segments), np.int32, n_seg)
        len_of = np.fromiter((s_.row_len for s_ in segments), np.int32, n_seg)
    else:
        group_all = tile_of = start_of = len_of = None
    seg_tile, seg_start, seg_len, seg_id, counts = _pack_segments(
        N, group_all, tile_of, start_of, len_of, t_max)

    plan = CompiledPlan(
        n_machines=N,
        rows_per_tile=rows_per_tile,
        stragglers=stragglers,
        segments=segments,
        seg_tile=seg_tile,
        seg_start=seg_start,
        seg_len=seg_len,
        seg_id=seg_id,
        n_valid=counts.astype(np.int32),
    )
    if n_seg:
        prio_all = np.asarray(
            [s_.priority for s_ in segments], np.int32).reshape(n_seg, L)
        plan._derived = (tile_of, start_of, len_of,
                        group_all.astype(np.int32), prio_all)
    return plan


def verify_plan_coverage(plan: CompiledPlan, n_tiles: int,
                         straggler_sets: Sequence[Sequence[int]] = ((),)) -> None:
    """Assert every global row is combined exactly once under each straggler
    set (and that redundancy is exactly 1+S). Raises AssertionError."""
    total = n_tiles * plan.rows_per_tile
    for bad in straggler_sets:
        mask = plan.include_mask(bad) > 0
        g = plan.seg_tile[mask].astype(np.int64)
        st = plan.seg_start[mask].astype(np.int64)
        ln = plan.seg_len[mask].astype(np.int64)
        base = g * plan.rows_per_tile + st
        # Difference-array scatter + prefix sum = per-row coverage counts.
        diff = np.zeros(total + 1, dtype=np.int64)
        np.add.at(diff, base, 1)
        np.add.at(diff, base + ln, -1)
        counts = np.cumsum(diff[:-1])
        if not np.all(counts == 1):
            missing = int(np.sum(counts == 0))
            dup = int(np.sum(counts > 1))
            raise AssertionError(
                f"coverage broken under stragglers={list(bad)}: "
                f"{missing} rows missing, {dup} rows duplicated"
            )
    L = 1 + plan.stragglers
    _, _, _, group, _ = plan.seg_arrays()
    if len(plan.segments):
        if group.shape[1] != L:
            raise AssertionError(
                f"segment groups are {group.shape[1]} wide, != 1+S = {L}")
        srt = np.sort(group, axis=1)
        distinct = (
            np.ones(len(plan.segments), bool) if L == 1
            else (srt[:, 1:] != srt[:, :-1]).all(axis=1)
        )
        if not distinct.all():
            sid = int(np.argmin(distinct))
            raise AssertionError(
                f"segment group {plan.segments[sid].group} != 1+S machines")
