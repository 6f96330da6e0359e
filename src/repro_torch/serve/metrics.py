"""Serving telemetry: per-request lifecycle counters and latency stats.

One :class:`ServerMetrics` instance observes a server's whole life:
admission decisions (enqueued / rejected / expired), completions (with
deadline hits and misses), queue depth, idle/stalled scheduler polls,
and per-window dispatch telemetry — the latter fed by the runner's
:meth:`~repro_torch.runtime.elastic_runner.ElasticRunner.add_completion_callback`
hook, so window counts and modeled device time come from the dispatch
layer itself, not from the server's bookkeeping.

:meth:`ServerMetrics.snapshot` exports everything as a structured dict
(p50/p99/mean/max latency, goodput, counters) — the single format
``bench_serve.py``, the CI smoke, and the tests consume. All times are
in the server clock's units; under the deterministic
:class:`~repro_torch.serve.server.SyntheticClock` the whole snapshot is
bit-reproducible, which is what lets CI assert on it.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

__all__ = ["ServerMetrics"]


def _percentile(values: List[float], q: float) -> float:
    if not values:
        return 0.0
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


class ServerMetrics:
    """Counters + distributions of one server's request stream."""

    def __init__(self):
        self.enqueued = 0
        self.completed = 0
        self.rejected = 0
        self.expired = 0
        self.deadline_missed = 0
        self.idle_polls = 0
        self.stalled_polls = 0
        self.queue_depth_max = 0
        # Fault/degradation telemetry (fed by the server's recovery path).
        self.faults = 0
        self.requeued = 0
        self.failed = 0
        self.backoff_polls = 0
        self.shed_events = 0
        self.restored_events = 0
        # Integrity telemetry (the server's Freivalds window audit; kept
        # separate from the fault counters — an audit failure is a
        # *detected-wrong-bits* event, not an announced fault).
        self.integrity_checks = 0
        self.integrity_failures = 0
        self.integrity_requeued = 0
        self.integrity_failed = 0
        self.batches = 0
        self.batch_requests: List[int] = []
        self.batch_cols_used: List[int] = []
        self.latencies: List[float] = []
        self.good_latencies: List[float] = []   # completed within deadline
        # Dispatch-layer telemetry (runner completion callbacks).
        self.windows = 0
        self.window_steps = 0
        self.modeled_device_time = 0.0
        self.t_first_enqueue: Optional[float] = None
        self.t_last_complete: Optional[float] = None

    # ------------------------------------------------------------------ #
    # Lifecycle observers (called by the server)
    # ------------------------------------------------------------------ #
    def on_enqueue(self, t: float, depth: int) -> None:
        self.enqueued += 1
        self.queue_depth_max = max(self.queue_depth_max, depth)
        if self.t_first_enqueue is None:
            self.t_first_enqueue = t

    def on_reject(self) -> None:
        self.rejected += 1

    def on_expire(self) -> None:
        self.expired += 1

    def on_idle(self) -> None:
        self.idle_polls += 1

    def on_stall(self) -> None:
        self.stalled_polls += 1

    def on_fault(self, requeued: int, failed: int) -> None:
        """One fault-aborted dispatch: ``requeued`` requests went back to
        the queue head, ``failed`` exhausted their retry budget."""
        self.faults += 1
        self.requeued += int(requeued)
        self.failed += int(failed)

    def on_integrity_check(self, ok: bool) -> None:
        """One Freivalds audit of a dispatched batch's result."""
        self.integrity_checks += 1
        if not ok:
            self.integrity_failures += 1

    def on_integrity_requeue(self, requeued: int, failed: int) -> None:
        """A failed audit discarded the batch's result: ``requeued``
        requests retry (idempotently, through the ordinary head-requeue
        machinery), ``failed`` exhausted their budget."""
        self.integrity_requeued += int(requeued)
        self.integrity_failed += int(failed)

    def on_backoff(self) -> None:
        """A poll refused to dispatch because the queue head's
        ``not_before`` (retry backoff) has not passed yet."""
        self.backoff_polls += 1

    def on_shed(self) -> None:
        """Degraded mode lowered the straggler tolerance to keep serving."""
        self.shed_events += 1

    def on_restore(self) -> None:
        """The fleet recovered; the base straggler tolerance is back."""
        self.restored_events += 1

    def on_batch(self, n_requests: int, cols_used: int) -> None:
        self.batches += 1
        self.batch_requests.append(int(n_requests))
        self.batch_cols_used.append(int(cols_used))

    def on_complete(self, latency: float, t_complete: float,
                    missed: bool) -> None:
        self.completed += 1
        self.latencies.append(float(latency))
        if missed:
            self.deadline_missed += 1
        else:
            self.good_latencies.append(float(latency))
        self.t_last_complete = t_complete

    def on_window(self, reports) -> None:
        """Runner completion callback: one call per device dispatch, with
        the window's StepReports (see
        :meth:`ElasticRunner.add_completion_callback`)."""
        self.windows += 1
        self.window_steps += len(reports)
        self.modeled_device_time += float(
            sum(r.modeled_completion for r in reports))

    # ------------------------------------------------------------------ #
    def snapshot(self) -> Dict:
        """The structured export the bench/CI/tests consume."""
        elapsed = 0.0
        if self.t_first_enqueue is not None \
                and self.t_last_complete is not None:
            elapsed = max(self.t_last_complete - self.t_first_enqueue, 0.0)
        goodput = (
            len(self.good_latencies) / elapsed if elapsed > 0 else 0.0
        )
        lat = self.latencies
        return {
            "requests": {
                "enqueued": self.enqueued,
                "completed": self.completed,
                "rejected": self.rejected,
                "expired": self.expired,
                "deadline_missed": self.deadline_missed,
            },
            "latency": {
                "n": len(lat),
                "p50": _percentile(lat, 50.0),
                "p99": _percentile(lat, 99.0),
                "mean": float(np.mean(lat)) if lat else 0.0,
                "max": float(np.max(lat)) if lat else 0.0,
            },
            "goodput_rps": goodput,
            "elapsed": elapsed,
            "queue": {
                "max_depth": self.queue_depth_max,
                "idle_polls": self.idle_polls,
                "stalled_polls": self.stalled_polls,
            },
            "batches": {
                "count": self.batches,
                "mean_requests": (
                    float(np.mean(self.batch_requests))
                    if self.batch_requests else 0.0),
                "mean_cols_used": (
                    float(np.mean(self.batch_cols_used))
                    if self.batch_cols_used else 0.0),
            },
            "windows": {
                "count": self.windows,
                "steps": self.window_steps,
                "modeled_device_time": self.modeled_device_time,
            },
            "faults": {
                "count": self.faults,
                "requeued": self.requeued,
                "failed": self.failed,
                "backoff_polls": self.backoff_polls,
                "shed_events": self.shed_events,
                "restored_events": self.restored_events,
            },
            "integrity": {
                "checks": self.integrity_checks,
                "failures": self.integrity_failures,
                "requeued": self.integrity_requeued,
                "failed": self.integrity_failed,
            },
        }
