"""Fleet churn, drawn from the seed: the Markov on/off process of the
repository's engine and runner benchmarks (``MarkovChurnTrace``).

Each machine flips available -> preempted with probability ``p_preempt``
and back with ``p_arrive`` per draw; a draw that would leave a tile with
fewer than ``min_holders`` live holders is drawn again (up to 64 times,
then the membership stays). The tile holders are the paper's placements,
worked out here from the configuration.
"""

from __future__ import annotations

import itertools
from typing import List, Tuple

import numpy as np


def holders(placement: str, n_machines: int, replication: int
            ) -> List[Tuple[int, ...]]:
    """Holders of each tile: cyclic (tile g on g .. g+J-1 mod N, G = N) or
    MAN (one tile per J-subset of the machines)."""
    n, j = n_machines, replication
    if placement == "cyclic":
        return [tuple(sorted((g + k) % n for k in range(j)))
                for g in range(n)]
    if placement == "man":
        return [tuple(c) for c in itertools.combinations(range(n), j)]
    raise ValueError(f"unknown placement {placement!r}")


class Churn:
    """A Markov on/off process over the fleet. :meth:`draw` returns the
    machines preempted and arrived by one draw."""

    def __init__(self, cfg: dict, churn: dict, rng: np.random.Generator):
        self.n = int(cfg["n_machines"])
        self.holders = holders(cfg["placement"], self.n,
                               int(cfg["replication"]))
        self.p_pre = float(churn["p_preempt"])
        self.p_arr = float(churn["p_arrive"])
        self.min_holders = int(churn["min_holders"])
        self.rng = rng
        self.available = set(range(self.n))

    def _ok(self, avail) -> bool:
        return all(sum(m in avail for m in hs) >= self.min_holders
                   for hs in self.holders)

    def draw(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        for _ in range(64):
            cur = self.available
            pre = {m for m in sorted(cur) if self.rng.random() < self.p_pre}
            off = sorted(set(range(self.n)) - cur)
            arr = {m for m in off if self.rng.random() < self.p_arr}
            nxt = (cur - pre) | arr
            if self._ok(nxt):
                self.available = nxt
                return tuple(sorted(pre)), tuple(sorted(arr))
        return (), ()
