"""Elasticity modeling: availability traces, membership events, transition waste.

The paper's elasticity model: at each computation step ``t`` a subset
``N_t ⊆ [N]`` of machines is available; machines are *preempted* (leave) and
*arrive* (return) between steps, with short notice. This module provides

- :class:`AvailabilityTrace` — deterministic or stochastic sequences of
  available sets (Markov on/off churn, targeted preemption, scripted events),
- :func:`transition_waste` — the metric of [Dau et al., ISIT'20]: how many
  row-assignment changes a re-plan causes beyond the unavoidable ones.

The runtime consumes traces step-by-step; nothing here touches jax.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

import numpy as np

from .placement import Placement


@dataclass
class ElasticEvent:
    """Membership change between step t-1 and step t."""

    step: int
    preempted: Tuple[int, ...]
    arrived: Tuple[int, ...]
    available: Tuple[int, ...]

    @property
    def is_churn(self) -> bool:
        """True when membership actually changed (traces emit one event per
        step, most of which are no-ops; runners count only real churn)."""
        return bool(self.preempted or self.arrived)


class AvailabilityTrace:
    """Generates the sequence N_0, N_1, ... of available machine sets."""

    def __init__(self, n_machines: int, available0: Optional[Sequence[int]] = None):
        self.n = n_machines
        self._avail: Set[int] = set(range(n_machines) if available0 is None else available0)
        self._step = 0

    @property
    def available(self) -> Tuple[int, ...]:
        return tuple(sorted(self._avail))

    def apply(self, preempt: Sequence[int] = (), arrive: Sequence[int] = ()) -> ElasticEvent:
        pre = tuple(sorted(set(preempt) & self._avail))
        arr = tuple(sorted((set(arrive) - self._avail) & set(range(self.n))))
        self._avail -= set(pre)
        self._avail |= set(arr)
        self._step += 1
        return ElasticEvent(self._step, pre, arr, self.available)


class MarkovChurnTrace(AvailabilityTrace):
    """Each machine flips available<->preempted with given per-step rates.

    A floor on |N_t| (default: the placement's minimum for tile reachability)
    rejects samples that would lose data, modelling the practical rule that a
    system never voluntarily drops below quorum.
    """

    def __init__(
        self,
        n_machines: int,
        p_preempt: float = 0.1,
        p_arrive: float = 0.3,
        min_available: int = 1,
        seed: int = 0,
        placement: Optional[Placement] = None,
        min_holders: int = 1,
    ):
        super().__init__(n_machines)
        self.p_pre = p_preempt
        self.p_arr = p_arrive
        self.min_avail = min_available
        self.placement = placement
        self.min_holders = min_holders  # 1+S for straggler-tolerant plans
        self.rng = np.random.default_rng(seed)

    def _ok(self, avail: Set[int]) -> bool:
        if len(avail) < self.min_avail:
            return False
        if self.placement is not None:
            try:
                r = self.placement.restrict(sorted(avail))
            except Exception:
                return False
            if r.replication < self.min_holders:
                return False
        return True

    def step(self) -> ElasticEvent:
        for _ in range(64):  # rejection-sample a legal transition
            cur = set(self._avail)
            pre = {n for n in cur if self.rng.random() < self.p_pre}
            off = set(range(self.n)) - cur
            arr = {n for n in off if self.rng.random() < self.p_arr}
            nxt = (cur - pre) | arr
            if self._ok(nxt):
                return self.apply(sorted(pre), sorted(arr))
        return self.apply()  # no legal churn found; keep membership


def scripted_trace(n_machines: int, script: Dict[int, Tuple[Sequence[int], Sequence[int]]]):
    """Yield ElasticEvents from {step: (preempt_list, arrive_list)}."""
    tr = AvailabilityTrace(n_machines)
    step = 0
    while True:
        pre, arr = script.get(step, ((), ()))
        yield tr.apply(pre, arr)
        step += 1


def transition_waste(
    prev_rows: Dict[int, Set[int]],
    new_rows: Dict[int, Set[int]],
    preempted: Sequence[int],
) -> int:
    """Transition waste of a re-plan (Dau et al., ISIT'20).

    ``prev_rows[n]`` / ``new_rows[n]``: the global row indices machine ``n``
    computes before/after the transition. The *necessary* changes are the rows
    whose machines were preempted (they must move somewhere); every additional
    add or drop on a surviving machine is waste:

        waste = sum_n |new[n] Δ prev[n]|  -  (rows forced to move)

    where the forced count includes both the adds (someone must pick orphaned
    rows up) — matching the reference definition of total minus necessary
    changes.
    """
    pre = set(preempted)
    orphaned: Set[int] = set()
    for n in pre:
        orphaned |= prev_rows.get(n, set())
    total_changes = 0
    for n in set(prev_rows) | set(new_rows):
        if n in pre:
            continue
        a = prev_rows.get(n, set())
        b = new_rows.get(n, set())
        total_changes += len(a ^ b)
    necessary = len(orphaned)  # each orphaned row must be added once somewhere
    return max(total_changes - necessary, 0)
