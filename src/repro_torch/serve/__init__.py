"""Elastic serving layer: multi-tenant query traffic on one elastic fleet.

The port of :mod:`repro.serve`; its modules are the JAX package's, with the
lanes running on the card.

Everything below :mod:`repro_torch.api` runs ONE job; this package runs MANY.
An :class:`ElasticServer` holds a shared staged operand (the matrix X,
replicated over the fleet by the placement exactly as for a single job)
and serves a stream of independent queries against it:

- ``matvec``  — one vector w, answer ``X @ w``;
- ``matmat``  — a (r, c) block W, answer ``X @ W``;
- ``mapreduce`` — the operand of a server-configured
  :class:`~repro_torch.api.workload.MapReduceRows` workload.

The batching axis is operand COLUMNS: the :class:`~repro_torch.serve.batcher.
Coalescer` packs queued matvec/matmat queries into one fixed-width
multi-column operand, so a batch of K queries dispatches as ONE device
window through the engine's reentrant :meth:`~repro_torch.api.engine.
ElasticEngine.submit` — the same program at every batch size (one
executor per lane for the server's life), and on the
exact integer-grid data of the parity tests each answer column is
bitwise-identical to a sequential single-query run. Map-reduce queries
run on their own lane and never merge with linear ones.

Admission control is explicit: a bounded queue rejects with a
``retry_after`` estimate instead of growing without bound, per-request
deadlines expire queued work and mark late completions, and preemption
is a *tail-latency* event — with every worker gone, queued requests
stall and complete after re-arrival instead of failing.

See :mod:`repro_torch.serve.server` for the front door (sync core +
:class:`AsyncElasticServer` asyncio wrapper), :mod:`repro_torch.serve.batcher`
for the coalescing rule, and :mod:`repro_torch.serve.metrics` for the
structured latency/goodput/queue telemetry the bench and CI consume.
"""

from .batcher import Batch, Coalescer
from .metrics import ServerMetrics
from .request import KINDS, LINEAR_KINDS, Request, Response, Ticket
from .server import (
    AsyncElasticServer,
    ElasticServer,
    RealClock,
    ServeConfig,
    SyntheticClock,
)

__all__ = [
    "AsyncElasticServer",
    "Batch",
    "Coalescer",
    "ElasticServer",
    "KINDS",
    "LINEAR_KINDS",
    "RealClock",
    "Request",
    "Response",
    "ServeConfig",
    "ServerMetrics",
    "SyntheticClock",
    "Ticket",
]
