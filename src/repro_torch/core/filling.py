"""The filling algorithm (paper Algorithm 2) and the homogeneous cyclic design.

Given the optimal fractional load column ``mu*_g`` for one sub-matrix
(``sum_n mu*_g[n] = 1 + S``, ``0 <= mu*_g[n] <= 1``), Algorithm 2 constructs an
*integral* computation assignment: ``F_g`` disjoint row fractions
``alpha_{g,1..F_g}`` (summing to 1) and machine groups ``P_{g,f}`` with
``|P_{g,f}| = 1 + S`` such that machine ``n``'s total assigned fraction equals
``mu*_g[n]`` exactly. Every row is then computed by exactly ``1 + S`` distinct
machines, which is what makes the step recoverable under any ``S`` stragglers.

Invariant maintained by the alpha rule (Lemma 1 of [Woolsey-Chen-Ji, TCOM'21]):
``max_n m[n] <= sum(m) / L`` with ``L = 1 + S``, which guarantees the greedy
peel always completes within ``N_g`` iterations.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

_ZERO = 1e-12


@dataclass(frozen=True)
class TileAssignment:
    """Integral assignment for one sub-matrix/tile g.

    Attributes:
      fractions: (F,) row fractions alpha_f, summing to 1.
      groups: length-F tuple; groups[f] = machine ids (global) computing row
        set f. Each has exactly ``1 + S`` distinct machines.
    """

    fractions: np.ndarray
    groups: Tuple[Tuple[int, ...], ...]

    @property
    def n_sets(self) -> int:
        return len(self.groups)

    def group_matrix(self) -> np.ndarray:
        """(F, L) int array of machine ids, one row per row-set."""
        if not self.groups:
            return np.zeros((0, 0), dtype=np.int64)
        return np.asarray(self.groups, dtype=np.int64)

    def load_of(self, machine: int) -> float:
        if not self.groups:
            return 0.0
        member = (self.group_matrix() == int(machine)).any(axis=1)
        return float(self.fractions[member].sum())


def fill_assignment(
    mu_g: Sequence[float],
    machines: Sequence[int],
    stragglers: int = 0,
) -> TileAssignment:
    """Run Algorithm 2 on one sub-matrix's load column.

    Args:
      mu_g: loads over the holder machines of this tile (dense over
        ``machines``), with ``sum(mu_g) == 1 + stragglers`` and entries in
        [0, 1].
      machines: global machine ids aligned with ``mu_g``.
      stragglers: S.

    Returns:
      TileAssignment with exact per-machine loads.
    """
    m = np.asarray(mu_g, dtype=np.float64).copy()
    ids = list(machines)
    ids_arr = np.asarray(ids, dtype=np.int64)
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
    # Guard: the invariant needs max <= sum/L.
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
        # P = smallest + (L-1) largest  (all of them when n_prime == L).
        # The indices are distinct by construction (order is a permutation);
        # the size check guards against degenerate slicing only.
        group_idx = (
            np.concatenate((order[:1], order[n_prime - L + 1:]))
            if L > 1 else order[:1]
        )
        if group_idx.size != L:  # pragma: no cover - only on degenerate ties
            raise RuntimeError("filling produced a malformed group")
        if n_prime >= L + 1:
            kth_largest_excl = float(m[order[n_prime - L]])  # ell[N'-L+1]
            alpha = min(l_prime / L - kth_largest_excl, float(m[order[0]]))
        else:
            alpha = float(m[order[0]])
        alpha = max(alpha, 0.0)
        if alpha <= _ZERO:
            # Numerical stall: force-zero the smallest element.
            m[order[0]] = 0.0
            continue
        m[group_idx] -= alpha
        m[np.abs(m) < _ZERO] = 0.0
        fractions.append(alpha)
        groups.append(tuple(np.sort(ids_arr[group_idx]).tolist()))
    else:  # pragma: no cover
        raise RuntimeError("filling did not terminate within N_g iterations")

    fr = np.asarray(fractions)
    # Exactness: fractions must sum to 1 (each row computed once per group).
    if abs(fr.sum() - 1.0) > 1e-7:
        raise RuntimeError(f"filling fractions sum to {fr.sum()}, expected 1")
    fr = fr / fr.sum()
    return TileAssignment(fr, tuple(groups))


def _rowsum_compacted(vals: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Per-row sum of the first ``counts[i]`` entries of each row.

    Bitwise-identical to ``vals[i, :counts[i]].sum()`` per row: rows are
    grouped by count and reduced along a contiguous axis, so NumPy applies
    the same pairwise-summation order as the scalar code's compressed-array
    ``m[nz].sum()``. This is what makes the batched peel bit-exact.
    """
    out = np.zeros(vals.shape[0], dtype=np.float64)
    for kk in np.unique(counts):
        k = int(kk)
        if k <= 0:
            continue
        rows = np.flatnonzero(counts == kk)
        out[rows] = vals[rows][:, :k].sum(axis=1)
    return out


def fill_assignment_batch(
    mu_rows: Sequence[Sequence[float]],
    machines_rows: Sequence[Sequence[int]],
    stragglers=0,
) -> List[TileAssignment]:
    """Algorithm 2 over a *stack* of independent (mu_g, machines) instances.

    The greedy peel runs for all instances at once: one global iteration
    advances every still-active instance by one peel step (compaction,
    sort, group pick, alpha subtraction — all (M, W)-vectorized), so the
    Python-interpreter cost is O(max iterations), not O(total iterations).
    Instances may have different holder counts and different straggler
    tolerances (``stragglers`` is an int or a length-M sequence).

    Bitwise contract: the returned list equals
    ``[fill_assignment(mu, ids, S) for ...]`` exactly — same floats, same
    bits — which the property suite asserts on randomized instances. The
    only float reductions (``l_prime``, the fraction normalizer) go through
    :func:`_rowsum_compacted`, everything else is elementwise.
    """
    M = len(mu_rows)
    if M != len(machines_rows):
        raise ValueError("mu_rows and machines_rows must align")
    if M == 0:
        return []
    if np.isscalar(stragglers):
        strag = np.full(M, int(stragglers), dtype=np.int64)
    else:
        strag = np.asarray(stragglers, dtype=np.int64)
        if strag.shape != (M,):
            raise ValueError("stragglers must be an int or a length-M sequence")
    L_arr = 1 + strag
    l_max = int(L_arr.max())

    n_arr = np.zeros(M, dtype=np.int64)
    mus = []
    idss = []
    for i, (mu, mach) in enumerate(zip(mu_rows, machines_rows)):
        mu = np.asarray(mu, dtype=np.float64)
        ids_i = np.asarray(list(mach), dtype=np.int64)
        if mu.ndim != 1 or ids_i.size != mu.size:
            raise ValueError(f"instance {i}: mu_g and machines must align")
        n_arr[i] = mu.size
        mus.append(mu)
        idss.append(ids_i)
    W = int(n_arr.max())
    m = np.zeros((M, W), dtype=np.float64)
    ids = np.full((M, W), np.iinfo(np.int64).max, dtype=np.int64)
    for i in range(M):
        m[i, : n_arr[i]] = mus[i]
        ids[i, : n_arr[i]] = idss[i]
    col = np.arange(W)[None, :]
    valid = col < n_arr[:, None]

    # Validation, in the scalar order (first offending instance raises).
    tot = _rowsum_compacted(m, n_arr)
    bad = np.abs(tot - L_arr) > 1e-6
    if bad.any():
        i = int(np.argmax(bad))
        raise ValueError(
            f"instance {i}: sum(mu_g) = {tot[i]} != 1+S = {int(L_arr[i])}")
    if np.any(m < -_ZERO) or np.any(np.where(valid, m, 0.0) > 1 + 1e-9):
        raise ValueError("mu_g entries must lie in [0, 1]")
    m = np.clip(m, 0.0, 1.0)
    tot = _rowsum_compacted(m, n_arr)
    if np.any(np.max(m, axis=1) > tot / L_arr + 1e-9):
        raise ValueError(
            "filling precondition violated: max(mu_g) > (1+S)^{-1} sum")

    fr_buf = np.zeros((M, W), dtype=np.float64)
    grp_buf = np.full((M, W, l_max), np.iinfo(np.int64).max, dtype=np.int64)
    fcount = np.zeros(M, dtype=np.int64)
    checks = np.zeros(M, dtype=np.int64)
    done = np.zeros(M, dtype=bool)
    col_l = np.arange(l_max)[None, :]

    while True:
        nzmask = (m > _ZERO) & valid & ~done[:, None]
        k = nzmask.sum(axis=1)
        done |= k == 0
        act = ~done
        if not act.any():
            break
        checks[act] += 1
        low = act & (k < L_arr)
        if low.any():
            i = int(np.argmax(low))
            raise RuntimeError(
                f"filling failed: {int(k[i])} non-zero loads < "
                f"group size {int(L_arr[i])}")
        # The scalar loop allows n+1 body executions, then its for-else
        # raises unconditionally — match that budget per instance.
        over = act & (checks > n_arr)
        if over.any():
            raise RuntimeError(
                "filling did not terminate within N_g iterations")

        # Compact each row's non-zero entries to the front (original order).
        cidx = np.argsort(~nzmask, axis=1, kind="stable")
        gath = np.take_along_axis(m, cidx, axis=1)
        l_prime = _rowsum_compacted(gath, np.where(act, k, 0))
        sval = np.where(col < k[:, None], gath, np.inf)
        sord = np.argsort(sval, axis=1, kind="stable")
        svals = np.take_along_axis(sval, sord, axis=1)
        scol = np.take_along_axis(cidx, sord, axis=1)

        # P = smallest + (L-1) largest: positions [0] + [k-L+1 .. k-1].
        gvalid = col_l < L_arr[:, None]
        pos = np.where(col_l == 0, 0, k[:, None] - L_arr[:, None] + col_l)
        pos = np.clip(pos, 0, W - 1)
        gcols = np.take_along_axis(scol, pos, axis=1)        # (M, l_max)

        v0 = svals[:, 0]
        kth = np.take_along_axis(
            svals, np.clip(k - L_arr, 0, W - 1)[:, None], axis=1)[:, 0]
        rich = k >= L_arr + 1
        with np.errstate(invalid="ignore"):
            alpha = np.where(
                rich, np.minimum(l_prime / L_arr - kth, v0), v0)
        alpha = np.maximum(alpha, 0.0)

        stall = act & (alpha <= _ZERO)
        emit = act & ~stall
        srows = np.flatnonzero(stall)
        if srows.size:
            # Numerical stall: force-zero the smallest element.
            m[srows, scol[srows, 0]] = 0.0
        erows = np.flatnonzero(emit)
        if erows.size:
            reps = L_arr[erows]
            rr = np.repeat(erows, reps)
            cc = gcols[erows][gvalid[erows]]
            m[rr, cc] -= np.repeat(alpha[erows], reps)
            sub = m[erows]
            m[erows] = np.where(np.abs(sub) < _ZERO, 0.0, sub)
            fr_buf[erows, fcount[erows]] = alpha[erows]
            gids = np.take_along_axis(ids[erows], gcols[erows], axis=1)
            gids = np.where(gvalid[erows], gids, np.iinfo(np.int64).max)
            grp_buf[erows, fcount[erows], :] = np.sort(gids, axis=1)
            fcount[erows] += 1

    fr_sum = _rowsum_compacted(fr_buf, fcount)
    bad = np.abs(fr_sum - 1.0) > 1e-7
    if bad.any():
        i = int(np.argmax(bad))
        raise RuntimeError(
            f"filling fractions sum to {fr_sum[i]}, expected 1")
    out: List[TileAssignment] = []
    for i in range(M):
        F = int(fcount[i])
        fr = fr_buf[i, :F] / fr_sum[i]
        li = int(L_arr[i])
        groups = tuple(
            tuple(grp_buf[i, f, :li].tolist()) for f in range(F)
        )
        out.append(TileAssignment(fr, groups))
    return out


def homogeneous_assignment(
    machines: Sequence[int],
    stragglers: int = 0,
) -> TileAssignment:
    """Cyclic equal-split design for homogeneous speeds (paper §IV).

    ``F_g = N_g`` equal row sets; set ``f`` is computed by machines
    ``{f, f+1, ..., f+S} (mod N_g)`` in the sorted holder order.
    """
    ids = sorted(int(x) for x in machines)
    n_g = len(ids)
    L = 1 + int(stragglers)
    if n_g < L:
        raise ValueError(f"{n_g} holders < 1+S={L}")
    fractions = np.full(n_g, 1.0 / n_g)
    groups = tuple(
        tuple(sorted(ids[(f + j) % n_g] for j in range(L))) for f in range(n_g)
    )
    return TileAssignment(fractions, groups)


def verify_assignment(
    assign: TileAssignment,
    mu_g: Sequence[float],
    machines: Sequence[int],
    stragglers: int = 0,
    tol: float = 1e-6,
) -> None:
    """Assert the Algorithm-2 output realizes mu_g exactly. Raises on failure."""
    L = 1 + int(stragglers)
    if abs(float(np.sum(assign.fractions)) - 1.0) > tol:
        raise AssertionError("fractions do not sum to 1")
    gm = assign.group_matrix()
    if gm.shape[0]:
        if gm.shape[1] != L:
            raise AssertionError(f"groups are not {L} machines wide: {gm.shape}")
        srt = np.sort(gm, axis=1)
        dup = (srt[:, 1:] == srt[:, :-1]).any(axis=1) if L > 1 else np.zeros(gm.shape[0], bool)
        if dup.any():
            f = int(np.argmax(dup))
            raise AssertionError(
                f"group {f} is not {L} distinct machines: {assign.groups[f]}"
            )
    ids = np.asarray(list(machines), dtype=np.int64)
    # Realized per-machine load, scattered over the (possibly non-contiguous)
    # global machine ids via index mapping.
    realized = np.zeros(ids.size)
    if gm.shape[0]:
        pos = np.searchsorted(np.sort(ids), gm.ravel())
        pos = np.argsort(ids, kind="stable")[pos]
        np.add.at(realized, pos, np.repeat(np.asarray(assign.fractions), L))
    err = np.abs(realized - np.asarray(mu_g, dtype=np.float64))
    if np.any(err > tol):
        i = int(np.argmax(err))
        raise AssertionError(
            f"machine {ids[i]}: realized load {realized[i]} != mu {float(mu_g[i])}"
        )
