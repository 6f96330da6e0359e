"""Request/response records of the serving layer.

A :class:`Request` is one admitted query with its lifecycle timestamps
(enqueue → dispatch → complete, all in the server clock's units); a
:class:`Response` is what the caller gets back — the sliced result plus
the same timestamps, so per-request latency is auditable from the
response alone. :class:`Ticket` is the admission decision itself:
``admitted=False`` carries the backpressure ``retry_after`` estimate
instead of queueing unboundedly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

KINDS: Tuple[str, ...] = ("matvec", "matmat", "mapreduce")
#: Kinds that coalesce into one multi-column linear window. ``mapreduce``
#: is deliberately absent: its executor is a different program,
#: so it never merges with linear queries (own lane, singleton batches).
LINEAR_KINDS: Tuple[str, ...] = ("matvec", "matmat")


@dataclass
class Request:
    """One admitted query. ``cols`` is its column footprint in a coalesced
    batch (1 for matvec, c for an (r, c) matmat, 0 for mapreduce — which
    dispatches alone). ``deadline`` is absolute server-clock time.

    ``retries`` counts fault-aborted dispatches this request survived
    (each one requeued it at the front); ``not_before`` is the absolute
    server-clock time before which the scheduler must not re-dispatch it
    (the exponential-backoff gate, None = immediately eligible).
    ``t_queued_ns`` is the enqueue on the span recorder's clock
    (:func:`repro_torch.runtime.tracing.stamp`; None while none records)."""

    rid: int
    kind: str
    operand: Any
    cols: int
    t_enqueue: float
    deadline: Optional[float] = None
    t_dispatch: Optional[float] = None
    t_complete: Optional[float] = None
    retries: int = 0
    not_before: Optional[float] = None
    t_queued_ns: Optional[int] = None


@dataclass
class Ticket:
    """The admission decision. ``admitted=False`` means the bounded queue
    was full: nothing was enqueued, retry after ``retry_after`` (the
    server's estimate of when a slot frees up, in clock units)."""

    rid: int
    admitted: bool
    retry_after: Optional[float] = None


@dataclass
class Response:
    """One finished (or refused) query.

    status: ``"ok"`` (result holds the answer), ``"expired"`` (deadline
    passed before dispatch; dropped un-run), ``"rejected"`` (the async
    wrapper's queue-full answer — the sync path signals rejection via
    :class:`Ticket`), ``"failed"`` (the request's dispatch fault-aborted
    more than ``ServeConfig.max_retries`` times; ``meta`` names the last
    fault), or ``"shutdown"`` (the async wrapper closed while the
    request was still pending — terminal, nothing ran).
    ``deadline_missed`` marks an ``"ok"`` response that completed after
    its deadline: the work was not wasted, but goodput accounting
    excludes it.
    """

    rid: int
    kind: str
    status: str
    result: Any = None
    retry_after: Optional[float] = None
    deadline_missed: bool = False
    batch_id: Optional[int] = None
    t_enqueue: Optional[float] = None
    t_dispatch: Optional[float] = None
    t_complete: Optional[float] = None
    meta: dict = field(default_factory=dict)

    @property
    def latency(self) -> Optional[float]:
        """Enqueue-to-complete time in server clock units (None unless
        the request actually completed)."""
        if self.t_enqueue is None or self.t_complete is None:
            return None
        return self.t_complete - self.t_enqueue
