"""Dinic max-flow with float capacities.

Used as the feasibility oracle for the USEC assignment LP (eq. (6)/(8) of the
paper): for a candidate completion time ``c``, feasibility of the coverage
constraints is a bipartite transportation problem, i.e. a max-flow instance

    source --(1+S)--> sub-matrix g --(1)--> machine n --(c * s[n])--> sink

with the (g, n) edge present iff machine ``n`` stores sub-matrix ``g``.  The
assignment is feasible at time ``c`` iff the max flow saturates every source
edge, i.e. equals ``(1+S) * G``.

The graph is tiny (G + N + 2 nodes, at most G*J + G + N edges) and is re-solved
~60 times inside a bisection, so a simple adjacency-list Dinic is plenty.
Capacities are floats; ``EPS`` guards BFS/DFS admissibility checks.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional, Tuple

import numpy as np

EPS = 1e-12


class Dinic:
    """Max-flow on a small directed graph with float capacities."""

    def __init__(self, n_nodes: int):
        self.n = n_nodes
        # Edge arrays: to[i], cap[i]; edge i^1 is the reverse of edge i.
        self.to: List[int] = []
        self.cap: List[float] = []
        self.head: List[List[int]] = [[] for _ in range(n_nodes)]

    def add_edge(self, u: int, v: int, capacity: float) -> int:
        """Add directed edge u->v. Returns the edge index (for flow queries)."""
        idx = len(self.to)
        self.to.append(v)
        self.cap.append(float(capacity))
        self.head[u].append(idx)
        self.to.append(u)
        self.cap.append(0.0)
        self.head[v].append(idx + 1)
        return idx

    def set_capacity(self, edge_idx: int, capacity: float) -> None:
        """Reset capacity of a forward edge (and zero its accumulated flow)."""
        # Forward residual = capacity, reverse residual = 0.
        self.cap[edge_idx] = float(capacity)
        self.cap[edge_idx ^ 1] = 0.0

    def _bfs(self, s: int, t: int) -> Optional[List[int]]:
        level = [-1] * self.n
        level[s] = 0
        q = deque([s])
        while q:
            u = q.popleft()
            for i in self.head[u]:
                v = self.to[i]
                if self.cap[i] > EPS and level[v] < 0:
                    level[v] = level[u] + 1
                    q.append(v)
        return level if level[t] >= 0 else None

    def _dfs(self, u: int, t: int, f: float, level: List[int], it: List[int]) -> float:
        if u == t:
            return f
        while it[u] < len(self.head[u]):
            i = self.head[u][it[u]]
            v = self.to[i]
            if self.cap[i] > EPS and level[v] == level[u] + 1:
                d = self._dfs(v, t, min(f, self.cap[i]), level, it)
                if d > EPS:
                    self.cap[i] -= d
                    self.cap[i ^ 1] += d
                    return d
            it[u] += 1
        return 0.0

    def max_flow(self, s: int, t: int) -> float:
        flow = 0.0
        while True:
            level = self._bfs(s, t)
            if level is None:
                return flow
            it = [0] * self.n
            while True:
                f = self._dfs(s, t, float("inf"), level, it)
                if f <= EPS:
                    break
                flow += f

    def flow_on(self, edge_idx: int) -> float:
        """Flow routed through forward edge ``edge_idx`` (= reverse residual)."""
        return self.cap[edge_idx ^ 1]

    def min_cut_reachable(self, s: int) -> np.ndarray:
        """Boolean mask of nodes reachable from ``s`` in the residual graph.

        Call after :meth:`max_flow`; the (reachable, unreachable) partition is a
        minimum cut.
        """
        seen = np.zeros(self.n, dtype=bool)
        seen[s] = True
        q = deque([s])
        while q:
            u = q.popleft()
            for i in self.head[u]:
                v = self.to[i]
                if self.cap[i] > EPS and not seen[v]:
                    seen[v] = True
                    q.append(v)
        return seen


class _ScipyFlowResult:
    """Adapter exposing the min-cut interface of :class:`Dinic` for the
    scipy backend (used by assignment.py's cut-refinement)."""

    def __init__(self, residual_csr, n_nodes: int):
        self._res = residual_csr
        self.n = n_nodes

    def min_cut_reachable(self, s: int) -> np.ndarray:
        from scipy.sparse import csgraph

        # BFS over edges with positive residual capacity.
        order, _ = csgraph.breadth_first_order(
            self._res, s, directed=True, return_predecessors=True
        )
        seen = np.zeros(self.n, dtype=bool)
        seen[order] = True
        return seen


def _scipy_transportation(supply, node_cap, edges, edge_cap, tol):
    """Integer-scaled max-flow via scipy.sparse.csgraph (much faster than the
    pure-python Dinic on large instances).

    scipy's max-flow silently misbehaves beyond int32 capacities, so node
    capacities are first clamped at just-above total demand (capacity beyond
    total demand never changes feasibility, and the strict margin keeps
    clamped nodes out of every min cut), then scaled into int32-safe range.
    The rounding fuzz is accounted for in the feasibility threshold; the
    bisection's exact-cut refinement removes any residual error from c*.
    """
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import maximum_flow

    G, N = len(supply), len(node_cap)
    src, snk = G + N, G + N + 1
    n_nodes = G + N + 2
    need = float(np.sum(supply))
    clamp = 1.001 * need + 1.0
    caps = np.minimum(np.asarray(node_cap, dtype=np.float64), clamp)
    cap_max = max(float(np.max(supply)), clamp, edge_cap, 1.0)
    scale = float(2 ** 31 - 64) / (cap_max * max(G + N, 4))
    scale = min(scale, float(2 ** 31 - 64) / cap_max)
    rows, cols, data = [], [], []
    for g in range(G):
        rows.append(src); cols.append(g); data.append(int(round(supply[g] * scale)))
    for (g, n) in edges:
        rows.append(g); cols.append(G + n); data.append(int(round(edge_cap * scale)))
    for n in range(N):
        c = int(caps[n] * scale)
        if c > 0:
            rows.append(G + n); cols.append(snk); data.append(c)
    graph = csr_matrix((data, (rows, cols)), shape=(n_nodes, n_nodes), dtype=np.int64)
    res = maximum_flow(graph, src, snk)
    flow_val = res.flow_value / scale
    fuzz = 4.0 * (G + N + len(edges)) / scale
    feasible = flow_val >= need - max(tol, fuzz)
    fl = res.flow  # sparse, antisymmetric
    mu = np.zeros((G, N))
    coo = fl.tocoo()
    for r, c, v in zip(coo.row, coo.col, coo.data):
        if v > 0 and r < G and G <= c < G + N:
            mu[r, c - G] = v / scale
    residual = (graph - fl).maximum(0).tocsr()  # forward residual
    # Reverse residual = flow along forward edges: add transpose of positive flow.
    residual = residual + fl.maximum(0).T.tocsr()
    return feasible, mu, _ScipyFlowResult(residual.tocsr(), n_nodes), None


_HAS_SCIPY = None


def transportation_feasible(
    supply: np.ndarray,
    node_cap: np.ndarray,
    edges: List[Tuple[int, int]],
    edge_cap: float = 1.0,
    tol: float = 1e-9,
):
    """Check feasibility of the USEC transportation problem.

    Args:
      supply: (G,) required coverage per sub-matrix (``1 + S`` each).
      node_cap: (N,) machine capacities (``c * s[n]``).
      edges: list of (g, n) pairs — machine n stores sub-matrix g.
      edge_cap: per-(g, n) cap on ``mu[g, n]`` (1.0 in the paper).
      tol: slack for calling the instance feasible.

    Returns:
      (feasible, mu, flownet, edge_ids) where ``mu`` is a (G, N) matrix of the
      routed assignment if feasible (else the best-effort flow) and
      ``flownet`` exposes ``min_cut_reachable`` for cut extraction.

    Uses scipy's C max-flow on large instances when available; falls back to
    the pure-python Dinic (always used on small instances, where it is both
    exact in float and faster than the scipy call overhead).
    """
    global _HAS_SCIPY
    G, N = len(supply), len(node_cap)
    if _HAS_SCIPY is None:
        try:
            from scipy.sparse.csgraph import maximum_flow  # noqa: F401
            _HAS_SCIPY = True
        except Exception:  # pragma: no cover
            _HAS_SCIPY = False
    if _HAS_SCIPY and (G + N) > 96:
        return _scipy_transportation(supply, node_cap, edges, edge_cap, tol)

    src, snk = G + N, G + N + 1
    d = Dinic(G + N + 2)
    for g in range(G):
        d.add_edge(src, g, float(supply[g]))
    gn_ids = []
    for (g, n) in edges:
        gn_ids.append(d.add_edge(g, G + n, edge_cap))
    for n in range(N):
        d.add_edge(G + n, snk, float(node_cap[n]))
    flow = d.max_flow(src, snk)
    need = float(np.sum(supply))
    feasible = flow >= need - tol
    mu = np.zeros((G, N))
    for (g, n), eid in zip(edges, gn_ids):
        mu[g, n] = d.flow_on(eid)
    return feasible, mu, d, gn_ids
