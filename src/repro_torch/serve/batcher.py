"""Coalescer: pack compatible queued queries into one device window.

The batching axis is operand COLUMNS. Linear queries (matvec / matmat)
against the shared staged matrix are all the same computation — ``Y = X @
W`` for some column block W — so K pending queries become ONE operand of
``batch_cols`` columns (zero-padded past the used span) and dispatch as
one window through the MatMat lane. The width is FIXED: every batch,
from a lone matvec to a full house, presents the executor with the same
(r, batch_cols) shape, so the lane's program count stays at one for the
life of the server.

Column slicing is exact, not approximate: worker n computes
``x_block @ W`` and column j of that product depends only on column j of
W, so on the integer-grid exact data the repo's parity tests use, the
sliced answer of a coalesced query is bitwise-identical to running it
alone (proven in ``tests/test_torch_serve.py`` under churn and under
``arrival="first"``).

Packing is strict FIFO: take queued requests from the head while they
fit. The first request that cannot join — a mapreduce query (different
executor, never merges with linear work) or a matmat block that would
overflow the remaining columns — ends the batch and leads the next one.
No reordering means no starvation: a wide matmat at the head is never
jumped by narrow queries behind it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Deque, List, Optional, Tuple

import numpy as np

from .request import LINEAR_KINDS, Request

__all__ = ["Batch", "Coalescer"]


@dataclass
class Batch:
    """One dispatchable window. ``kind`` is the lane ("linear" |
    "mapreduce"); ``operand`` is the padded (r, batch_cols) column block
    for linear batches, the request's own operand for mapreduce;
    ``col_spans[i]`` is request i's [start, stop) column slice of the
    window result."""

    batch_id: int
    kind: str
    requests: List[Request]
    operand: Any
    col_spans: List[Tuple[int, int]] = field(default_factory=list)

    @property
    def cols_used(self) -> int:
        return sum(r.cols for r in self.requests)


class Coalescer:
    """FIFO column-packing of queued queries into fixed-width windows."""

    def __init__(self, operand_rows: int, batch_cols: int):
        if batch_cols < 1:
            raise ValueError(f"batch_cols must be >= 1, got {batch_cols}")
        self.operand_rows = int(operand_rows)
        self.batch_cols = int(batch_cols)
        self._next_batch = 0

    def pack(self, queue: "Deque[Request]") -> Optional[Batch]:
        """Pop the head batch off ``queue`` (mutates it). None when empty."""
        if not queue:
            return None
        bid = self._next_batch
        self._next_batch += 1
        head = queue[0]
        if head.kind not in LINEAR_KINDS:
            # Map-reduce: own lane, own executor — refuses to coalesce
            # with linear queries (and with other mapreduce queries: the
            # workload's combine is a fold over ALL rows, so two queries'
            # results cannot be sliced apart after the fact).
            queue.popleft()
            return Batch(batch_id=bid, kind="mapreduce", requests=[head],
                         operand=head.operand)
        taken: List[Request] = []
        spans: List[Tuple[int, int]] = []
        used = 0
        while queue and queue[0].kind in LINEAR_KINDS \
                and used + queue[0].cols <= self.batch_cols:
            req = queue.popleft()
            taken.append(req)
            spans.append((used, used + req.cols))
            used += req.cols
        operand = np.zeros((self.operand_rows, self.batch_cols),
                           dtype=np.float32)
        for req, (a, b) in zip(taken, spans):
            w = np.asarray(req.operand, dtype=np.float32)
            operand[:, a:b] = w[:, None] if w.ndim == 1 else w
        return Batch(batch_id=bid, kind="linear", requests=taken,
                     operand=operand, col_spans=spans)
