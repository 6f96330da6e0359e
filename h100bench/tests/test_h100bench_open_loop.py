"""The open-loop generator sends on schedule and times from due times."""

import time

import numpy as np
import pytest

from h100bench.traffic import open_loop


class SlowServer:
    """Answers every queued query after ``dispatch_s``; records when each
    poll returned."""

    def __init__(self, dispatch_s):
        self.dispatch_s = dispatch_s
        self.queue = []
        self.returned = {}
        self.rid = 0

    @property
    def queue_depth(self):
        return len(self.queue)

    def submit(self, kind, operand):
        from types import SimpleNamespace

        self.queue.append(self.rid)
        self.rid += 1
        return SimpleNamespace(rid=self.rid - 1, admitted=True)

    def poll(self):
        from types import SimpleNamespace

        time.sleep(self.dispatch_s)
        out = [SimpleNamespace(rid=r, status="ok", result=np.zeros(1))
               for r in self.queue]
        self.queue = []
        t = time.perf_counter()
        for r in out:
            self.returned[r.rid] = t
        return out

    def feed_event(self, preempted=(), arrived=()):
        pass


def test_every_seed_sends_the_same_count():
    counts = {len(open_loop.arrivals(s, 150.0, 20.0, 64)[0])
              for s in (1, 2, 2 ** 31 + 5, 2 ** 40)}
    assert counts == {3000}
    due, which = open_loop.arrivals(9, 150.0, 20.0, 64)
    assert np.all(np.diff(due) >= 0) and due[0] >= 0 and due[-1] <= 20.0
    assert which.min() >= 0 and which.max() < 64


def test_latency_runs_from_the_due_time():
    srv = SlowServer(0.05)
    due = np.linspace(0.0, 0.4, 41)
    t0 = time.perf_counter()
    out = open_loop.serve(srv, [np.zeros(1)] * 4, due,
                          np.zeros(len(due), int), None, 0.5, 0.4)
    assert not np.isnan(out["latency_s"]).any()
    # The generator's clock starts just after t0: each latency is the
    # answering poll's return less the due time, never less than it.
    for q, lat in enumerate(out["latency_s"]):
        want = srv.returned[q] - t0 - due[q]
        assert lat == pytest.approx(want, abs=2e-3)
        assert lat >= 0.05 - 1e-3          # a whole dispatch at least
    # Queries due during a dispatch wait for it: the mean is well above
    # one dispatch.
    assert out["latency_s"].mean() > 0.06
    assert sum(k for _, k in out["polls"]) == len(due)


def test_a_stalled_server_leaves_queries_unanswered():
    class Stalled(SlowServer):
        def poll(self):
            time.sleep(0.01)
            return []

    srv = Stalled(0.0)
    due = np.array([0.0, 0.01])
    old = open_loop.GRACE_S
    open_loop.GRACE_S = 0.2
    try:
        out = open_loop.serve(srv, [np.zeros(1)], due, np.zeros(2, int),
                              None, 0.5, 0.05)
    finally:
        open_loop.GRACE_S = old
    assert np.isnan(out["latency_s"]).all()
