"""The serving front door: admission, scheduling, dispatch, responses.

The port of :mod:`repro.serve.server`. Both lanes are prepared on the card
(``device=None``; ``device="cpu"`` runs the plain PyTorch versions), the
linear lane through the ``usec_matvec`` kernel (``usec_segmented`` with
``EngineConfig(segmented=...)``). The reference's ``mesh=`` /
``worker_axis=`` arguments place workers on a JAX device mesh; on one card
every worker runs on the same device, so they are left out.

:class:`ElasticServer` is a synchronous core deliberately: every state
transition (admit, expire, coalesce, dispatch, respond) happens inside
an explicit :meth:`ElasticServer.poll` call, so tests and the bench can
drive the whole request lifecycle deterministically — no background
thread, no wall-clock coupling. :class:`AsyncElasticServer` wraps it in
an asyncio loop for callers that want ``await server.request(...)``.

Layout: one **lane** (a prepared :class:`~repro_torch.api.engine.ElasticEngine`)
per executor family over the SAME staged data. The linear lane is a
:class:`~repro_torch.api.workload.MatMat` engine whose fixed ``batch_cols``-wide
operand carries the coalesced matvec/matmat queries of a batch; the
optional mapreduce lane runs the server-configured
:class:`~repro_torch.api.workload.MapReduceRows` workload one query at a time.
Each lane builds exactly one program (``executor_cache_size`` stays at 1,
reported as the reference's ``jit_cache_size``), and churn reaches both
lanes as plan-array swaps.

Clocks: the server's notion of time is a :class:`RealClock`
(``time.monotonic``) or a :class:`SyntheticClock` — the latter advances
only when the server advances it, by each dispatched window's *modeled*
completion time (the runner clock's duration model). Paired with a
zero-jitter :class:`~repro_torch.runtime.elastic_runner.SyntheticSpeedClock`
on the engine, every latency in the metrics snapshot is a deterministic
function of the request trace — CI asserts structure, not timing.

Elasticity: callers feed preemption/arrival through
:meth:`ElasticServer.feed_event`. The server tracks fleet availability
itself and hands each lane a synthesized
:class:`~repro_torch.core.elastic.ElasticEvent` at its next dispatch — so a
lane that has not dispatched through several membership changes sees one
net event, and a fleet with NO serveable membership (all workers gone,
or a tile with zero live holders) simply stalls: queued requests
survive and dispatch after re-arrival. Preemption is tail latency, not
failure.
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.api import ElasticEngine, EngineConfig, MatMat, Policy
from repro_torch.core.elastic import ElasticEvent
from repro_torch.core.placement import LostTileError, Placement
from repro_torch.faults import FaultAbort
from repro_torch.runtime import tracing

from .batcher import Batch, Coalescer
from .metrics import ServerMetrics
from .request import KINDS, Request, Response, Ticket

__all__ = [
    "AsyncElasticServer",
    "ElasticServer",
    "RealClock",
    "ServeConfig",
    "SyntheticClock",
]


class RealClock:
    """Wall time (monotonic). The production clock."""

    def now(self) -> float:
        return time.monotonic()


class SyntheticClock:
    """Deterministic server time: advances only when told to.

    The server advances it by each dispatched window's modeled completion
    (scaled by ``ServeConfig.latency_scale``); trace drivers advance it
    by inter-arrival gaps. Nothing reads the wall, so a request trace
    replays to bit-identical timestamps, latencies and goodput.
    """

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance time backwards (dt={dt})")
        self._t += float(dt)
        return self._t


@dataclass(frozen=True)
class ServeConfig:
    """Admission and batching knobs of one server.

    batch_cols: fixed column width of the linear lane's coalesced
      operand — the maximum columns one window carries, and the ONLY
      operand width the executor ever sees (a lone matvec dispatches as
      1 used + ``batch_cols - 1`` zero columns; a matmat wider than this
      is refused at submit).
    max_queue: bounded queue depth; a submit past it is rejected with a
      ``retry_after`` estimate instead of queueing (backpressure).
    default_deadline: per-request deadline in clock units from enqueue,
      applied when a submit names none (None = no deadline).
    latency_scale: clock units per modeled-completion unit when
      advancing a :class:`SyntheticClock` past a dispatch (real clocks
      ignore it — time advances by itself).
    max_retries: fault-aborted dispatches one request survives before
      the server answers ``"failed"`` instead of requeueing it (the
      abort fires BEFORE the dispatch mutates anything, so a requeue is
      idempotent — the request re-dispatches bit-identical).
    retry_backoff: base of the exponential re-dispatch delay after a
      fault: a request on its k-th retry is not re-dispatched before
      ``retry_backoff * 2**(k-1)`` clock units have passed (0 = retry
      on the next poll).
    degraded: what an unserveable-but-reachable fleet does to the queue.
      ``"stall"`` (default): requests wait for re-arrival, the paper's
      announced-churn behaviour. ``"shed"``: the server lowers every
      lane's straggler tolerance to the largest S the surviving holders
      still cover and keeps serving — degraded fault tolerance instead
      of unavailability — restoring the configured S when the fleet
      recovers.
    verify_results: end-to-end result integrity of the linear lane.
      ``"always"`` Freivalds-audits every coalesced window's result
      (``O(rows + cols)`` per column — no recompute) before any response
      is emitted; a failed audit discards the window and requeues its
      requests idempotently through the ordinary head-requeue/backoff
      machinery, counted under the snapshot's ``integrity`` section
      (NOT as a fault — wrong bits are a different failure class than
      an announced abort). ``"always"`` compares within a float
      tolerance scaled by ``Σ|X|·|w|`` (any data); ``"exact"`` runs the
      same audit with an exact comparison, for integer-grid data (the
      exactness contract's ``make_exact_matrix`` with integer operands),
      where every sketch product is exact in float64 — at the paper's
      6000 x 6000 size the tolerance exceeds the injected corruption's
      shift, so only the exact audit catches it there. ``"off"`` trusts
      the fleet.
    """

    batch_cols: int = 8
    max_queue: int = 64
    default_deadline: Optional[float] = None
    latency_scale: float = 1.0
    max_retries: int = 2
    retry_backoff: float = 0.0
    degraded: str = "stall"
    verify_results: str = "off"

    def __post_init__(self):
        if self.batch_cols < 1:
            raise ValueError(
                f"batch_cols must be >= 1, got {self.batch_cols}")
        if self.max_queue < 1:
            raise ValueError(
                f"max_queue must be >= 1, got {self.max_queue}")
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}")
        if self.retry_backoff < 0:
            raise ValueError(
                f"retry_backoff must be >= 0, got {self.retry_backoff}")
        if self.degraded not in ("stall", "shed"):
            raise ValueError(
                f"degraded must be 'stall' or 'shed', got {self.degraded!r}")
        if self.verify_results not in ("off", "always", "exact"):
            raise ValueError(
                f"verify_results must be 'off', 'always' or 'exact', got "
                f"{self.verify_results!r}")


class ElasticServer:
    """Multi-tenant query service over one elastic fleet.

    Args:
      data: the shared staged matrix X (the rows every lane's placement
        replicates; queries are answered against it).
      policy / engine_cfg: the per-lane scheduling policy and engine
        knobs — the SAME objects a single-job run would use.
      serve_cfg: admission/batching knobs (:class:`ServeConfig`).
      mapreduce: a :class:`~repro_torch.api.workload.MapReduceRows` instance
        to open the mapreduce lane (None = lane closed; mapreduce
        submits are refused).
      clock: server time (:class:`RealClock` default).
      engine_clock: per-worker duration source handed to the lanes (see
        :class:`~repro_torch.runtime.elastic_runner.SyntheticSpeedClock`).
      n_machines / placement: fleet shape, as for
        :class:`~repro_torch.api.engine.ElasticEngine`.
      device: where both lanes stage the matrix and run (None = the card;
        ``"cpu"`` runs the plain versions).
      fault_injector: a :class:`~repro_torch.faults.FaultInjector` installed on
        the linear lane's runner (chaos testing). Injected faults the S
        budget covers are masked inside the dispatch; uncovered ones
        abort it (:class:`~repro_torch.faults.FaultAbort`) and the server
        demotes the lost workers, requeues the batch idempotently, and
        re-dispatches under the retry budget.
    """

    def __init__(
        self,
        data: np.ndarray,
        policy: Policy = Policy(),
        engine_cfg: EngineConfig = EngineConfig(),
        serve_cfg: ServeConfig = ServeConfig(),
        mapreduce=None,
        clock=None,
        engine_clock=None,
        n_machines: Optional[int] = None,
        placement: Optional[Placement] = None,
        fault_injector=None,
        device=None,
    ):
        self.cfg = serve_cfg
        self.clock = clock if clock is not None else RealClock()
        self.metrics = ServerMetrics()
        data = np.asarray(data)
        self.operand_rows = int(data.shape[1])
        self.placement = (
            placement if placement is not None
            else policy.make_placement(int(n_machines))
        )
        self._lanes: Dict[str, ElasticEngine] = {}
        linear = ElasticEngine(
            MatMat(), policy, engine_cfg, backend="device",
            placement=self.placement, clock=engine_clock, device=device,
        )
        linear.prepare(data)
        linear.runner.add_completion_callback(self.metrics.on_window)
        self._lanes["linear"] = linear
        if mapreduce is not None:
            mr = ElasticEngine(
                mapreduce, policy, engine_cfg, backend="device",
                placement=self.placement, clock=engine_clock, device=device,
            )
            mr.prepare(data)
            mr.runner.add_completion_callback(self.metrics.on_window)
            self._lanes["mapreduce"] = mr
        self.fault_injector = fault_injector
        if fault_injector is not None:
            self._lanes["linear"].runner.fault_injector = fault_injector
        self._auditor = None
        self._audit_count = 0
        if serve_cfg.verify_results != "off":
            from repro_torch.faults.integrity import IntegrityChecker

            # Sketch-only (no staged replica array): the server audits
            # end-to-end — whatever path produced the window, its result
            # must satisfy r·y == (r·X)·w. "always" takes arbitrary float
            # data, so the tolerance comparison; "exact" the integer grid.
            self._auditor = IntegrityChecker(
                data, staged=None, block_rows=engine_cfg.block_rows,
                linear=True, exact=serve_cfg.verify_results == "exact")
        self._base_stragglers = {
            name: eng.runner.planning_master.stragglers
            for name, eng in self._lanes.items()
        }
        self._shed = False
        self._coalescer = Coalescer(self.operand_rows, serve_cfg.batch_cols)
        self._queue: Deque[Request] = deque()
        self._available = set(range(self.placement.n_machines))
        self._next_rid = 0
        self._last_window_latency = 0.0

    # ------------------------------------------------------------------ #
    # Admission
    # ------------------------------------------------------------------ #
    @tracing.traced("serve.submit", "_next_rid")
    def submit(self, kind: str, operand: Any = None,
               deadline: Optional[float] = None) -> Ticket:
        """Admit one query. ``deadline`` is clock units from NOW (falls
        back to ``ServeConfig.default_deadline``; None = no deadline).
        Returns the admission :class:`Ticket`; a full queue rejects with
        ``admitted=False`` and a ``retry_after`` estimate. Malformed
        queries (unknown kind, wrong operand shape, a matmat wider than
        ``batch_cols``, a mapreduce submit with the lane closed) raise
        ``ValueError`` — client errors, not backpressure."""
        cols = self._admit_check(kind, operand)
        now = self.clock.now()
        if len(self._queue) >= self.cfg.max_queue:
            self.metrics.on_reject()
            return Ticket(rid=-1, admitted=False,
                          retry_after=self._retry_after())
        rid = self._next_rid
        self._next_rid += 1
        rel = deadline if deadline is not None else self.cfg.default_deadline
        req = Request(
            rid=rid, kind=kind, operand=operand, cols=cols, t_enqueue=now,
            deadline=None if rel is None else now + float(rel),
            t_queued_ns=tracing.stamp(),
        )
        self._queue.append(req)
        self.metrics.on_enqueue(now, depth=len(self._queue))
        return Ticket(rid=rid, admitted=True)

    def _admit_check(self, kind: str, operand) -> int:
        if kind not in KINDS:
            raise ValueError(
                f"kind must be one of {KINDS}, got {kind!r}")
        if kind == "mapreduce":
            if "mapreduce" not in self._lanes:
                raise ValueError(
                    "mapreduce lane is closed: construct "
                    "ElasticServer(mapreduce=MapReduceRows(...)) to open it")
            return 0
        w = np.asarray(operand)
        if kind == "matvec":
            if w.ndim != 1 or w.shape[0] != self.operand_rows:
                raise ValueError(
                    f"matvec operand must be ({self.operand_rows},), "
                    f"got {w.shape}")
            return 1
        if w.ndim != 2 or w.shape[0] != self.operand_rows:
            raise ValueError(
                f"matmat operand must be ({self.operand_rows}, c), "
                f"got {w.shape}")
        if w.shape[1] > self.cfg.batch_cols:
            raise ValueError(
                f"matmat operand has {w.shape[1]} columns; this server "
                f"coalesces at batch_cols={self.cfg.batch_cols} — split "
                f"the query or raise batch_cols")
        return int(w.shape[1])

    def _retry_after(self) -> float:
        """Backpressure hint: queued windows × the last window's latency
        (a small floor before any window has completed)."""
        windows = max(
            1, math.ceil(len(self._queue) / self.cfg.batch_cols))
        return windows * max(self._last_window_latency, 1e-6)

    # ------------------------------------------------------------------ #
    # Elasticity
    # ------------------------------------------------------------------ #
    def feed_event(self, preempted=(), arrived=()) -> None:
        """Record fleet churn. Pure bookkeeping: lanes learn about it as
        a synthesized net event at their next dispatch, so membership
        changes while idle (or while stalled) cost nothing."""
        N = self.placement.n_machines
        for n in tuple(preempted) + tuple(arrived):
            if not 0 <= int(n) < N:
                raise ValueError(f"machine id {n} outside fleet [0, {N})")
        self._available -= {int(n) for n in preempted}
        self._available |= {int(n) for n in arrived}

    @property
    def available(self):
        return tuple(sorted(self._available))

    def serveable(self) -> bool:
        """True when the current fleet can dispatch: every tile reachable
        AND plannable — ``1 + S`` live holders per tile, the straggler
        tolerance's feasibility bar. A fleet below it (including ALL
        workers gone) stalls the queue: requests wait for re-arrival
        instead of failing mid-dispatch."""
        if not self._available:
            return False
        try:
            self.placement.restrict(self.available)
        except LostTileError:
            return False
        need = 1 + max(
            eng.runner.planning_master.stragglers
            for eng in self._lanes.values())
        avail = self._available
        return all(
            sum(n in avail for n in hs) >= need
            for hs in self.placement.holders)

    def _lane_event(self, engine: ElasticEngine) -> Optional[ElasticEvent]:
        runner = engine.runner
        avail = self.available
        if avail == runner.membership:
            return None
        cur = set(runner.membership)
        new = set(avail)
        return ElasticEvent(
            step=runner._step,
            preempted=tuple(sorted(cur - new)),
            arrived=tuple(sorted(new - cur)),
            available=avail,
        )

    # ------------------------------------------------------------------ #
    # Scheduling
    # ------------------------------------------------------------------ #
    @tracing.traced("serve.poll")
    def poll(self) -> List[Response]:
        """One scheduler iteration: expire overdue queued requests, then
        dispatch at most ONE coalesced window. Returns the responses it
        produced (possibly none: empty queue is an idle tick, an
        unserveable fleet is a stall tick — both counted, neither
        blocking)."""
        now = self.clock.now()
        out: List[Response] = []
        if self._queue:
            kept: Deque[Request] = deque()
            for req in self._queue:
                if req.deadline is not None and now > req.deadline:
                    self.metrics.on_expire()
                    out.append(Response(
                        rid=req.rid, kind=req.kind, status="expired",
                        t_enqueue=req.t_enqueue))
                else:
                    kept.append(req)
            self._queue = kept
        if not self._queue:
            self.metrics.on_idle()
            return out
        head = self._queue[0]
        if head.not_before is not None and now < head.not_before:
            self.metrics.on_backoff()
            return out
        if self._shed:
            self._maybe_restore()
        if not self.serveable():
            if not (self.cfg.degraded == "shed" and self._maybe_shed()):
                self.metrics.on_stall()
                return out
        with tracing.span("serve.pack"):
            batch = self._coalescer.pack(self._queue)
        out.extend(self._dispatch(batch))
        return out

    def drain(self, max_polls: Optional[int] = None) -> List[Response]:
        """Poll until the queue empties, the fleet stalls (or the head
        request is backoff-gated), or ``max_polls`` is hit. Stalled
        requests stay queued — feed an arrival and drain again."""
        out: List[Response] = []
        polls = 0
        m = self.metrics
        while self._queue:
            if max_polls is not None and polls >= max_polls:
                break
            idle = (m.stalled_polls, m.backoff_polls, m.idle_polls)
            out.extend(self.poll())
            polls += 1
            if (m.stalled_polls, m.backoff_polls, m.idle_polls) != idle:
                break  # this poll went nowhere; only time/churn unblocks it
        return out

    def _dispatch(self, batch: Batch) -> List[Response]:
        engine = self._lanes[batch.kind]
        ev = self._lane_event(engine)
        t_dispatch = self.clock.now()
        for req in batch.requests:
            req.t_dispatch = t_dispatch
        try:
            with tracing.span("serve.dispatch", batch.batch_id):
                t_sent_ns = tracing.stamp()
                result, reports = engine.submit(batch.operand, event=ev)
        except FaultAbort as fa:
            return self._on_fault(batch, fa, t_dispatch)
        self._drain_demotions(engine)
        if self._auditor is not None and batch.kind == "linear":
            # End-to-end window audit BEFORE any response is emitted: a
            # result that fails the sketch never reaches a client.
            self._audit_count += 1
            ok = self._auditor.check_output(
                self._audit_count, np.asarray(result), batch.operand)
            self.metrics.on_integrity_check(ok)
            if not ok:
                return self._on_integrity_failure(batch, t_dispatch)
        with tracing.span("serve.respond", batch.batch_id):
            if t_sent_ns is not None:
                # Each answered request's wait, from its enqueue to the
                # dispatch that answers it (a requeued one waits on).
                for req in batch.requests:
                    tracing.record_async("serve.queued", req.rid,
                                         req.t_queued_ns, t_sent_ns)
            modeled = self.cfg.latency_scale * float(
                sum(r.modeled_completion for r in reports))
            if hasattr(self.clock, "advance"):
                self.clock.advance(modeled)
            t_complete = self.clock.now()
            self._last_window_latency = max(t_complete - t_dispatch, modeled)
            self.metrics.on_batch(len(batch.requests), batch.cols_used)

            out: List[Response] = []
            for i, req in enumerate(batch.requests):
                req.t_complete = t_complete
                if batch.kind == "linear":
                    a, b = batch.col_spans[i]
                    res = np.asarray(result)[:, a:b]
                    if req.kind == "matvec":
                        res = res[:, 0]
                else:
                    res = result
                missed = (req.deadline is not None
                          and t_complete > req.deadline)
                self.metrics.on_complete(
                    t_complete - req.t_enqueue, t_complete, missed)
                out.append(Response(
                    rid=req.rid, kind=req.kind, status="ok", result=res,
                    deadline_missed=missed, batch_id=batch.batch_id,
                    t_enqueue=req.t_enqueue, t_dispatch=req.t_dispatch,
                    t_complete=t_complete,
                ))
            return out

    # ------------------------------------------------------------------ #
    # Unannounced-failure recovery
    # ------------------------------------------------------------------ #
    def _on_fault(self, batch: Batch, fa: FaultAbort,
                  now: float) -> List[Response]:
        """An uncovered fault aborted the dispatch. The abort fires
        BEFORE the dispatch mutates engine state and before any response
        was emitted, so requeueing the batch at the queue head is
        idempotent: the retry re-dispatches the same queries bit for bit.
        The lost workers are demoted (announced-preemption bookkeeping);
        a request past ``max_retries`` gets a terminal ``"failed"``
        response; survivors pick up an exponential-backoff ``not_before``
        when ``retry_backoff`` is set."""
        if fa.demote:
            self.feed_event(preempted=fa.demote)
        out, kept = self._requeue_batch(
            batch, now,
            {"fault": fa.kind, "step": fa.step, "lost": list(fa.lost)})
        self.metrics.on_fault(requeued=kept, failed=len(out))
        return out

    def _on_integrity_failure(self, batch: Batch,
                              now: float) -> List[Response]:
        """The window's result failed the Freivalds audit: wrong bits
        from SOME producer, with no announced fault to blame. The result
        is discarded — no response was emitted, the dispatch consumed no
        request state — and the batch requeues through the same
        idempotent head-requeue/backoff machinery an abort uses, under
        the same retry budget. Deliberately NOT counted as a fault
        (``tests`` pin the fault section's shape); the snapshot's
        ``integrity`` section carries these."""
        out, kept = self._requeue_batch(
            batch, now, {"integrity": "audit_failure"})
        self.metrics.on_integrity_requeue(requeued=kept, failed=len(out))
        return out

    def _requeue_batch(self, batch: Batch, now: float,
                       fail_meta: Dict) -> Tuple[List[Response], int]:
        """Shared discard-and-retry tail of both recovery paths: bump
        each request's retry count, answer ``"failed"`` past the budget,
        stamp backoff on the survivors, and put them back at the queue
        head in order. Returns (failed responses, requeued count)."""
        out: List[Response] = []
        kept: List[Request] = []
        for req in batch.requests:
            req.retries += 1
            req.t_dispatch = None
            if req.retries > self.cfg.max_retries:
                out.append(Response(
                    rid=req.rid, kind=req.kind, status="failed",
                    t_enqueue=req.t_enqueue,
                    meta=dict(fail_meta, retries=req.retries),
                ))
            else:
                if self.cfg.retry_backoff > 0:
                    req.not_before = now + self.cfg.retry_backoff * (
                        2.0 ** (req.retries - 1))
                kept.append(req)
        self._queue.extendleft(reversed(kept))
        return out, len(kept)

    def _drain_demotions(self, engine: ElasticEngine) -> None:
        """Covered crashes mask the step but still kill the worker: the
        runner parks them in ``pending_demotions``; fold them into the
        server's availability so every lane sees the loss at its next
        dispatch."""
        pend = getattr(engine.runner, "pending_demotions", None)
        if pend:
            self.feed_event(preempted=sorted(pend))
            pend.clear()

    def _min_cover(self) -> int:
        """Live holders of the thinnest tile (0 when a tile is lost
        outright — no straggler tolerance makes that fleet serveable)."""
        if not self._available:
            return 0
        try:
            self.placement.restrict(self.available)
        except LostTileError:
            return 0
        avail = self._available
        return min(
            sum(n in avail for n in hs) for hs in self.placement.holders)

    def _maybe_shed(self) -> bool:
        """Degraded mode: drop every lane's straggler tolerance to what
        the surviving holders still cover, so the queue keeps moving with
        reduced fault tolerance instead of stalling. Returns True when
        the fleet is serveable afterwards."""
        cover = self._min_cover()
        if cover < 1:
            return False
        s_fit = cover - 1
        changed = False
        for eng in self._lanes.values():
            if eng.runner.planning_master.stragglers > s_fit:
                eng.runner.set_stragglers(s_fit)
                changed = True
        if changed:
            self._shed = True
            self.metrics.on_shed()
        return self.serveable()

    def _maybe_restore(self) -> None:
        """Undo a shed once the fleet covers the configured tolerance
        again (re-arrivals): every lane returns to its base S."""
        cover = self._min_cover()
        if cover < 1 + max(self._base_stragglers.values()):
            return
        for name, eng in self._lanes.items():
            if eng.runner.planning_master.stragglers \
                    != self._base_stragglers[name]:
                eng.runner.set_stragglers(self._base_stragglers[name])
        self._shed = False
        self.metrics.on_restore()

    # ------------------------------------------------------------------ #
    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def metrics_snapshot(self) -> Dict:
        """The metrics dict plus live per-lane dispatch-layer state
        (executor program counts, under the reference's ``jit_cache_size``
        key, and runner counters)."""
        snap = self.metrics.snapshot()
        snap["queue"]["depth"] = len(self._queue)
        snap["lanes"] = {
            name: {
                "jit_cache_size": eng.runner.executor_cache_size,
                "device_dispatches": eng.runner.device_dispatches,
                "churn_events": eng.runner.churn_events,
                "plans_compiled": eng.runner.plans_compiled,
                "cache_hits": eng.runner.cache_hits,
            }
            for name, eng in self._lanes.items()
        }
        return snap


class AsyncElasticServer:
    """Thin asyncio front door over the synchronous core.

    ``await request(...)`` admits a query and resolves with its
    :class:`Response`; a full queue resolves immediately with a
    ``"rejected"`` response carrying ``retry_after``. The :meth:`run`
    coroutine is the scheduler: it polls the core, resolving waiters as
    windows complete, and yields to the event loop between polls (the
    device dispatch itself is a blocking call — this wrapper provides
    concurrency of WAITING, not of device execution).
    """

    def __init__(self, server: ElasticServer, idle_sleep: float = 0.001):
        import asyncio  # local: the sync core stays import-light

        self._asyncio = asyncio
        self.server = server
        self.idle_sleep = float(idle_sleep)
        self._waiters: Dict[int, Any] = {}
        self._closed = False

    async def request(self, kind: str, operand: Any = None,
                      deadline: Optional[float] = None) -> Response:
        if self._closed:
            return Response(rid=-1, kind=kind, status="shutdown")
        ticket = self.server.submit(kind, operand, deadline=deadline)
        if not ticket.admitted:
            return Response(rid=ticket.rid, kind=kind, status="rejected",
                            retry_after=ticket.retry_after)
        loop = self._asyncio.get_running_loop()
        fut = loop.create_future()
        self._waiters[ticket.rid] = (fut, kind)
        return await fut

    async def run(self) -> None:
        """Serve until :meth:`close`; resolves waiters as responses
        arrive. On exit — close, or any escaping exception — every
        still-pending waiter resolves with a terminal ``"shutdown"``
        response, so no caller awaits forever."""
        try:
            while not self._closed:
                responses = self.server.poll()
                for resp in responses:
                    entry = self._waiters.pop(resp.rid, None)
                    if entry is not None and not entry[0].done():
                        entry[0].set_result(resp)
                if not responses and self.server.queue_depth == 0:
                    await self._asyncio.sleep(self.idle_sleep)
                else:
                    await self._asyncio.sleep(0)
        finally:
            self._fail_pending()

    def close(self) -> None:
        """Stop serving. Terminal for every pending request: each one
        resolves with a ``"shutdown"`` response immediately — not on the
        run loop's next iteration, which may never come."""
        self._closed = True
        self._fail_pending()

    def _fail_pending(self) -> None:
        waiters, self._waiters = self._waiters, {}
        for rid, (fut, kind) in waiters.items():
            if not fut.done():
                fut.set_result(
                    Response(rid=rid, kind=kind, status="shutdown"))
