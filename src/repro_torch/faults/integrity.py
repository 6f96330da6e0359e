"""End-to-end result integrity for uncoded elastic computing.

A NumPy copy of :mod:`repro.faults.integrity` (no torch, no JAX): the
checker runs on the host. Its tile audit reads whichever checksums it is
handed: zlib over the host copy of the staged replicas, or, on the card,
the ``tile_checksum`` kernel's CRC32s of the card's copy, which equal zlib's
bit for bit.

USEC storage is uncoded: unlike coded elastic computing there is no
parity to catch a worker that returns a *wrong* answer on time, and
every fault kind in :mod:`repro_torch.faults.chaos` before this module
announced itself by absence.  This module closes that gap with three
pieces, none of which recompute the work they check:

**Freivalds sketches** (results).  At staging time we draw a small bank
of seeded ``±1`` sketch vectors ``r_k`` over the global rows and
precompute, per ``block_rows``-sized row chunk ``c``, the products
``s_k[c] = r_k[rows_c] · X[rows_c]`` (one ``O(rows·cols)`` pass, paid
once).  A step's output ``y ?= X @ w`` is then checked as
``r_k · y == (Σ_c s_k[c]) · w`` in ``O(rows + cols)`` per operand
column — the classic Freivalds identity, with the sketch index
``k = step % K`` fixed by the step so replays are deterministic.  On
the exact-integer grid every quantity is exactly representable in
float64, the comparison is ``==``, and a clean run can never trip it;
off the grid a scaled tolerance derived from ``Σ|X|`` is used.  A
failed aggregate check is localized to row chunks by comparing per
chunk, which names the worker that delivered those rows.

**Tile fingerprints** (storage).  ``stage()``-time CRC32 checksums of
every replica tile, re-checked before dispatch on verified steps.  A
tile whose bytes drifted is re-staged from a surviving replica holder
whose own copy still matches — the uncoded-redundancy recovery: the
paper's J-fold row replication (§III storage placement) already holds
the bits needed to repair silent storage corruption without demoting
anyone.

**Worker health** (quarantine).  Each corrupt result is a strike;
repeat offenders are graylisted — treated as realized stragglers for a
probation window, which the include-mask machinery makes free and
plan-invariant — then re-admitted.  Corrupted-step timings are censored
from the EWMA (:func:`censor_measurements`), so corruption can never
poison future plans.
"""

from __future__ import annotations

import zlib
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

__all__ = [
    "SAMPLE_PERIOD",
    "IntegrityChecker",
    "WorkerHealth",
    "censor_measurements",
    "corrupt_result",
    "corrupt_tile",
    "should_verify",
    "tile_checksum",
]

#: Cadence of ``verify_results="sample"``: steps whose index is a
#: multiple of this are verified, the rest run unchecked.
SAMPLE_PERIOD = 4


def should_verify(mode: str, step: int) -> bool:
    """Does ``verify_results=mode`` check step ``step``?"""
    if mode == "always":
        return True
    if mode == "sample":
        return step % SAMPLE_PERIOD == 0
    return False


def tile_checksum(tile: np.ndarray) -> int:
    """CRC32 of a staged tile's bytes (content fingerprint)."""
    return zlib.crc32(np.ascontiguousarray(tile).tobytes())


def censor_measurements(
    loads: Dict[int, float],
    durations: Dict[int, float],
    quarantined: Iterable[int],
) -> Tuple[Dict[int, float], Dict[int, float]]:
    """Drop quarantined workers' step measurements before they reach the
    EWMA.  A corrupt result's timing is as untrustworthy as its payload;
    feeding it to :class:`~repro_torch.core.speed.SpeedEstimator` would skew
    every future plan.  Returns new ``(loads, durations)`` dicts — the
    surviving entries are untouched, so the estimator update is
    bit-identical to one that never saw the quarantined worker."""
    q = {int(n) for n in quarantined}
    return (
        {n: v for n, v in loads.items() if n not in q},
        {n: v for n, v in durations.items() if n not in q},
    )


def corrupt_tile(tile: np.ndarray, n_elems: int = 3) -> None:
    """The ``tile_corruption`` injection: flip the top mantissa bit of
    the first ``n_elems`` elements in place — a silent bit-rot model
    that changes the bytes without touching shape or dtype."""
    flat = tile.reshape(-1)
    k = min(int(n_elems), flat.shape[0])
    bits = flat[:k].view(np.uint32) if flat.dtype == np.float32 \
        else flat[:k].view(np.uint64)
    bits ^= type(bits[0])(1 << (22 if flat.dtype == np.float32 else 51))


def corrupt_result(y: np.ndarray, row: int) -> None:
    """The ``result_corruption`` injection: shift ONE element of a
    returned partial, in place.  A single-element perturbation is the
    adversary's best case — any ``±1`` sketch still sees the full shift,
    so detection has no cancellation escape hatch."""
    y2 = y if y.ndim > 1 else y.reshape(y.shape[0], 1)
    delta = 4.0 * (1.0 + float(np.max(np.abs(y2))))
    y2[int(row), 0] += y2.dtype.type(delta)


class WorkerHealth:
    """Per-worker strike ledger with graylist probation.

    ``strike(n, step)`` records one corrupt result from worker ``n``;
    the ``graylist_after``-th strike graylists it for ``probation``
    steps, during which :meth:`graylisted` reports it and the runner
    treats it as a realized straggler (excluded from the combine and the
    EWMA, plan untouched).  When probation lapses the strikes reset and
    the worker is re-admitted."""

    def __init__(self, graylist_after: int = 2, probation: int = 4):
        if graylist_after < 1:
            raise ValueError(
                f"graylist_after must be >= 1, got {graylist_after}")
        self.graylist_after = int(graylist_after)
        self.probation = int(probation)
        self.strikes: Dict[int, int] = {}
        self._until: Dict[int, int] = {}

    def strike(self, worker: int, step: int) -> bool:
        """Record a strike; returns True when this strike graylists."""
        n = int(worker)
        self.strikes[n] = self.strikes.get(n, 0) + 1
        if self.strikes[n] >= self.graylist_after:
            self._until[n] = int(step) + 1 + self.probation
            return True
        return False

    def graylisted(self, step: int) -> Set[int]:
        """Workers on probation at ``step`` (expired entries are
        re-admitted with a clean slate)."""
        out: Set[int] = set()
        for n, until in list(self._until.items()):
            if step < until:
                out.add(n)
            else:
                del self._until[n]
                self.strikes.pop(n, None)
        return out


class IntegrityChecker:
    """Freivalds sketches + tile fingerprints + health for one staged
    matrix.

    Args:
      x: the global row-tiled matrix ``(rows, cols)`` (host copy).
      staged: ``StagedMatrix.staged`` — the ``(N, T, rows_per_tile,
        cols)`` replica array to fingerprint, or None to skip tile
        auditing (e.g. the serving layer's window audit, which only
        needs the sketches).
      slot_of / holders: the placement's tile→slot map and per-tile
        holder lists (required with ``staged``).
      block_rows: the dispatch block height — the localization grain of
        a failed check (plans assign work in ``block_rows`` rows, so a
        bad chunk names its producer).
      linear: whether the workload is a linear map of its operand
        (``y = X @ w``).  Freivalds only applies to linear workloads;
        tile fingerprints are workload-agnostic.
      exact: use bitwise ``==`` comparison (the exact-integer grid) vs
        a scaled tolerance (arbitrary float data).
    """

    def __init__(
        self,
        x: np.ndarray,
        staged: Optional[np.ndarray] = None,
        slot_of: Optional[np.ndarray] = None,
        holders: Optional[Sequence[Sequence[int]]] = None,
        block_rows: int = 16,
        n_sketches: int = 2,
        seed: int = 0,
        linear: bool = True,
        exact: bool = True,
        rel_tol: float = 1e-3,
        graylist_after: int = 2,
        probation: int = 4,
    ):
        x64 = np.asarray(x, dtype=np.float64)
        rows, cols = x64.shape
        if rows % block_rows != 0:
            raise ValueError(
                f"rows ({rows}) must be a multiple of block_rows "
                f"({block_rows})")
        self.block_rows = int(block_rows)
        self.n_chunks = rows // self.block_rows
        self.n_sketches = int(n_sketches)
        self.linear = bool(linear)
        self.exact = bool(exact)
        self.rel_tol = float(rel_tol)
        self.health = WorkerHealth(graylist_after, probation)
        self.checks = 0
        self.failures = 0
        self.tile_audits = 0

        if self.linear:
            rng = np.random.default_rng(seed)
            # ±1 sketch bank, float64: products with grid values stay
            # exactly representable.
            self.sketches = rng.choice(
                np.array([-1.0, 1.0]), size=(self.n_sketches, rows))
            xc = x64.reshape(self.n_chunks, self.block_rows, cols)
            rc = self.sketches.reshape(
                self.n_sketches, self.n_chunks, self.block_rows)
            # (K, C, cols): the per-chunk sketched rows, paid once.
            self.chunk_products = np.einsum("kcb,cbr->kcr", rc, xc)
            self.full_products = self.chunk_products.sum(axis=1)
            # Tolerance scale: Σ|x| per chunk (|±1| = 1, so this bounds
            # |r·X_chunk| independent of the sketch).
            self.chunk_scale = np.abs(xc).sum(axis=1)
            self.full_scale = self.chunk_scale.sum(axis=0)
        else:
            self.sketches = None

        self.fingerprints: Dict[Tuple[int, int], int] = {}
        self.tile_of: Dict[Tuple[int, int], int] = {}
        self.slot_of = None
        self.holders = None
        if staged is not None:
            self.slot_of = np.asarray(slot_of)
            self.holders = tuple(
                tuple(int(m) for m in hs) for hs in holders)
            n_machines, n_tiles = self.slot_of.shape
            for n in range(n_machines):
                for g in range(n_tiles):
                    s = int(self.slot_of[n, g])
                    if s >= 0:
                        self.fingerprints[(n, s)] = tile_checksum(
                            staged[n, s])
                        self.tile_of[(n, s)] = g

    # ------------------------------------------------------------------ #
    # Freivalds result checks
    # ------------------------------------------------------------------ #
    @staticmethod
    def _as2d(a) -> np.ndarray:
        a = np.asarray(a, dtype=np.float64)
        return a[:, None] if a.ndim == 1 else a

    def _compare(self, lhs, rhs, scale) -> bool:
        if self.exact:
            return bool(np.array_equal(lhs, rhs))
        return bool(np.all(np.abs(lhs - rhs) <= self.rel_tol * (scale + 1.0)))

    def sketch_index(self, step: int) -> int:
        return int(step) % self.n_sketches

    def check_output(self, step: int, y, w) -> bool:
        """Aggregate Freivalds check of one full output ``y ?= X @ w``
        in ``O(rows + cols)`` per operand column."""
        if not self.linear:
            return True
        k = self.sketch_index(step)
        y2, w2 = self._as2d(y), self._as2d(w)
        lhs = self.sketches[k] @ y2
        rhs = self.full_products[k] @ w2
        scale = self.full_scale @ np.abs(w2)
        self.checks += 1
        ok = self._compare(lhs, rhs, scale)
        if not ok:
            self.failures += 1
        return ok

    def check_chunks(self, step: int, y, w, chunks: Iterable[int]) -> bool:
        """Aggregate check restricted to ``chunks`` — the rows one
        worker produced (first-arrival verifies each loaded partial
        independently so a corrupt one is named before the combine)."""
        if not self.linear:
            return True
        idx = np.asarray(sorted({int(c) for c in chunks}), dtype=np.int64)
        if idx.size == 0:
            return True
        k = self.sketch_index(step)
        y2, w2 = self._as2d(y), self._as2d(w)
        br = self.block_rows
        rows = (idx[:, None] * br + np.arange(br)).ravel()
        lhs = self.sketches[k][rows] @ y2[rows]
        rhs = self.chunk_products[k][idx].sum(axis=0) @ w2
        scale = self.chunk_scale[idx].sum(axis=0) @ np.abs(w2)
        self.checks += 1
        ok = self._compare(lhs, rhs, scale)
        if not ok:
            self.failures += 1
        return ok

    def locate(self, step: int, y, w,
               chunks: Optional[Iterable[int]] = None) -> List[int]:
        """Per-chunk comparison: the row chunks whose sketch disagrees.
        Only run after an aggregate check fails — localization costs
        ``O(n_chunks · cols)`` more than the aggregate pass."""
        if not self.linear:
            return []
        k = self.sketch_index(step)
        y2, w2 = self._as2d(y), self._as2d(w)
        br = self.block_rows
        idx = (range(self.n_chunks) if chunks is None
               else sorted({int(c) for c in chunks}))
        wabs = np.abs(w2)
        bad: List[int] = []
        for c in idx:
            rows = slice(c * br, (c + 1) * br)
            lhs = self.sketches[k][rows] @ y2[rows]
            rhs = self.chunk_products[k][c] @ w2
            scale = self.chunk_scale[c] @ wabs
            if not self._compare(lhs, rhs, scale):
                bad.append(int(c))
        return bad

    def chunk_rows(self, chunk: int) -> slice:
        return slice(chunk * self.block_rows, (chunk + 1) * self.block_rows)

    # ------------------------------------------------------------------ #
    # Tile fingerprints
    # ------------------------------------------------------------------ #
    @staticmethod
    def _checksum(staged, sums, n: int, s: int) -> int:
        return (tile_checksum(staged[n, s]) if sums is None
                else int(sums[n, s]))

    def audit_tiles(
        self, staged: np.ndarray,
        workers: Optional[Iterable[int]] = None,
        sums=None,
    ) -> List[Tuple[int, int, int]]:
        """Re-checksum every fingerprinted tile (optionally one
        worker subset); returns ``(worker, slot, tile)`` mismatches.
        ``sums[n, s]`` are precomputed checksums of the copy to audit
        (the card's, from the ``tile_checksum`` kernel); None computes
        them from ``staged``."""
        self.tile_audits += 1
        return self.tile_mismatches(staged, workers, sums)

    def tile_mismatches(
        self, staged: Optional[np.ndarray],
        workers: Optional[Iterable[int]] = None,
        sums=None,
    ) -> List[Tuple[int, int, int]]:
        """:meth:`audit_tiles` without counting an audit (the staging-time
        check that the card's copy starts out clean)."""
        allow = None if workers is None else {int(n) for n in workers}
        out: List[Tuple[int, int, int]] = []
        for (n, s), crc in self.fingerprints.items():
            if allow is not None and n not in allow:
                continue
            if self._checksum(staged, sums, n, s) != crc:
                out.append((n, s, self.tile_of[(n, s)]))
        return out

    def find_donor(
        self, staged: np.ndarray, tile: int, exclude: int,
        alive: Iterable[int], sums=None,
    ) -> Optional[int]:
        """A surviving replica holder of ``tile`` whose own copy still
        matches its staging-time fingerprint — the re-staging source.
        ``sums`` as in :meth:`audit_tiles`."""
        alive_set = {int(n) for n in alive}
        for m in self.holders[tile]:
            if m == int(exclude) or m not in alive_set:
                continue
            s = int(self.slot_of[m, tile])
            if self._checksum(staged, sums, m, s) == self.fingerprints[(m, s)]:
                return m
        return None

    def restage(self, staged: np.ndarray, worker: int, slot: int,
                tile: int, donor: int) -> None:
        """Copy ``donor``'s replica of ``tile`` over ``worker``'s
        corrupt slot.  Replicas are byte-identical by construction, so
        the repaired tile matches its original fingerprint again."""
        staged[int(worker), int(slot)] = \
            staged[int(donor), int(self.slot_of[int(donor), tile])]

    def replica_recompute(self, staged: np.ndarray, donor: int,
                          chunk: int, w, rows_per_tile: int) -> np.ndarray:
        """Recompute one corrupt row chunk from ``donor``'s replica tile
        in float64 (cast back by the caller).  On the exact grid this
        equals the device's float32 result bit for bit — the fused-window
        repair path, where a barrier re-dispatch would break the one-
        compiled-program contract."""
        br = self.block_rows
        g = (chunk * br) // int(rows_per_tile)
        off = chunk * br - g * int(rows_per_tile)
        tile = staged[int(donor), int(self.slot_of[int(donor), g])]
        w2 = self._as2d(w)
        out = tile[off:off + br].astype(np.float64) @ w2
        return out if np.asarray(w).ndim > 1 else out[:, 0]

    # ------------------------------------------------------------------ #
    def counters(self) -> Dict[str, int]:
        return {
            "checks": int(self.checks),
            "sketch_failures": int(self.failures),
            "tile_audits": int(self.tile_audits),
        }
