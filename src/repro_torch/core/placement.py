"""Uncoded storage placements for USEC (paper §II–III).

A placement assigns each of the ``G`` sub-matrices (more generally: work
*tiles*) to a set of machines. The paper studies three placements:

- **repetition** (fractional repetition): machines are split into ``N/J``
  groups of ``J``; each group stores an equal contiguous share of the
  sub-matrices. Every sub-matrix is held by all ``J`` machines of one group.
- **cyclic**: sub-matrix ``g`` is stored on machines ``{g, g+1, ..., g+J-1}
  (mod N)`` — the classic gradient-coding / distributed-storage pattern.
- **MAN** (Maddah-Ali–Niesen coded-caching placement): one sub-matrix per
  ``J``-subset of machines, ``G = C(N, J)``; machine ``n`` stores the
  sub-matrices of all subsets containing ``n``.

All placements here are *uncoded*: machines store verbatim copies, so any
holder can compute any row of a stored sub-matrix (this is the U in USEC).

The object is deliberately framework-agnostic — "machines" are whatever the
runtime maps them to (EC2 VMs in the paper; data-parallel mesh slices here).
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Placement:
    """An uncoded storage placement Z = {Z_n : n in [N]}.

    Attributes:
      n_machines: N, total machines in the system.
      holders: tuple of length G; ``holders[g]`` is the sorted tuple of
        machines that store sub-matrix/tile ``g``.
      name: placement family name (repetition/cyclic/man/custom).
    """

    n_machines: int
    holders: Tuple[Tuple[int, ...], ...]
    name: str = "custom"

    # ------------------------------------------------------------------ #
    # Derived views
    # ------------------------------------------------------------------ #
    @property
    def n_tiles(self) -> int:
        return len(self.holders)

    @property
    def replication(self) -> int:
        """J, if the placement is J-regular; else the minimum replication."""
        return min(len(h) for h in self.holders)

    def storage_sets(self) -> List[FrozenSet[int]]:
        """Z_n per machine: which tiles machine n stores."""
        z: List[set] = [set() for _ in range(self.n_machines)]
        for g, hs in enumerate(self.holders):
            for n in hs:
                z[n].add(g)
        return [frozenset(s) for s in z]

    def holder_matrix(self) -> np.ndarray:
        """(G, N) boolean matrix: H[g, n] = tile g stored on machine n."""
        H = np.zeros((self.n_tiles, self.n_machines), dtype=bool)
        for g, hs in enumerate(self.holders):
            H[g, list(hs)] = True
        return H

    def edges(self) -> List[Tuple[int, int]]:
        """All (g, n) storage pairs, in deterministic order."""
        return [(g, n) for g, hs in enumerate(self.holders) for n in hs]

    # ------------------------------------------------------------------ #
    # Elasticity
    # ------------------------------------------------------------------ #
    def restrict(self, available: Sequence[int]) -> "Placement":
        """Placement as seen by the available machine set N_t.

        Machines keep their *global* indices (the paper indexes machines in
        [N] throughout; preempted machines simply do not appear in any
        holder set). Raises if some tile loses all of its holders — that is
        a data-availability failure, not a scheduling failure.
        """
        avail = set(int(a) for a in available)
        new_holders = []
        for g, hs in enumerate(self.holders):
            kept = tuple(n for n in hs if n in avail)
            if not kept:
                raise LostTileError(
                    f"tile {g} lost all holders {hs}; available={sorted(avail)}"
                )
            new_holders.append(kept)
        return Placement(self.n_machines, tuple(new_holders), self.name)

    def max_tolerable_losses(self) -> int:
        """Any K machines may vanish while all tiles stay reachable iff
        K <= min_g |holders(g)| - 1."""
        return self.replication - 1

    def validate(self) -> None:
        for g, hs in enumerate(self.holders):
            if len(hs) == 0:
                raise ValueError(f"tile {g} has no holders")
            if len(set(hs)) != len(hs):
                raise ValueError(f"tile {g} has duplicate holders {hs}")
            if any(not (0 <= n < self.n_machines) for n in hs):
                raise ValueError(f"tile {g} holder out of range: {hs}")


class LostTileError(RuntimeError):
    """Raised when elasticity removes every holder of some tile."""


# ---------------------------------------------------------------------- #
# Placement constructors (paper §III)
# ---------------------------------------------------------------------- #
def repetition_placement(n_machines: int, n_tiles: int, replication: int) -> Placement:
    """Fractional repetition placement (paper Fig. 1a).

    Requires ``replication | n_machines`` and ``(n_machines/replication) |
    n_tiles``: machines form ``N/J`` groups of ``J``; group ``k`` stores the
    ``k``-th contiguous block of ``G / (N/J)`` tiles.
    """
    N, G, J = n_machines, n_tiles, replication
    if N % J != 0:
        raise ValueError(f"repetition needs J | N (got N={N}, J={J})")
    n_groups = N // J
    if G % n_groups != 0:
        raise ValueError(f"repetition needs (N/J) | G (got G={G}, N/J={n_groups})")
    per_group = G // n_groups
    holders = []
    for g in range(G):
        k = g // per_group
        holders.append(tuple(range(k * J, (k + 1) * J)))
    return Placement(N, tuple(holders), "repetition")


def cyclic_placement(n_machines: int, n_tiles: int, replication: int) -> Placement:
    """Cyclic placement (paper Fig. 1b): tile g on machines {g, .., g+J-1} mod N."""
    N, G, J = n_machines, n_tiles, replication
    if J > N:
        raise ValueError(f"replication J={J} exceeds N={N}")
    holders = []
    for g in range(G):
        base = g % N
        holders.append(tuple(sorted((base + j) % N for j in range(J))))
    return Placement(N, tuple(holders), "cyclic")


def man_placement(n_machines: int, replication: int) -> Placement:
    """Maddah-Ali–Niesen placement: one tile per J-subset of [N].

    G = C(N, J); machine n stores C(N-1, J-1) tiles. This is the placement
    the paper finds best in mean and variance (Table I).
    """
    N, J = n_machines, replication
    holders = tuple(
        tuple(subset) for subset in itertools.combinations(range(N), J)
    )
    return Placement(N, holders, "man")


def custom_placement(n_machines: int, holders: Sequence[Sequence[int]]) -> Placement:
    p = Placement(n_machines, tuple(tuple(sorted(h)) for h in holders), "custom")
    p.validate()
    return p


_FACTORIES = {
    "repetition": lambda N, G, J: repetition_placement(N, G, J),
    "cyclic": lambda N, G, J: cyclic_placement(N, G, J),
    "man": lambda N, G, J: man_placement(N, J),
}


def make_placement(kind: str, n_machines: int, n_tiles: int, replication: int) -> Placement:
    """Factory. For ``man`` the tile count is forced to C(N, J): a positive
    ``n_tiles`` that disagrees with C(N, J) is an error (callers that need a
    specific G should re-tile their data to the placement's G); pass 0 (or
    the correct count) to accept the derived value."""
    if kind not in _FACTORIES:
        raise ValueError(f"unknown placement {kind!r}; choose from {sorted(_FACTORIES)}")
    if kind == "man":
        derived = math.comb(n_machines, replication)
        if n_tiles and n_tiles != derived:
            raise ValueError(
                f"man placement has G = C(N={n_machines}, J={replication}) = "
                f"{derived} tiles; requested n_tiles={n_tiles} would be "
                f"silently ignored — pass 0 (or {derived}) to accept the "
                f"derived count, or re-tile the data"
            )
    p = _FACTORIES[kind](n_machines, n_tiles, replication)
    p.validate()
    return p
