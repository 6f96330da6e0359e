"""The port's serving layer (``repro_torch.serve``) against the JAX
package's contracts (``tests/test_serve.py``) and CLI.

- **Pure units**: the Coalescer's strict-FIFO column packing (including the
  mapreduce refusal and overflow), the metrics snapshot, the synthetic
  clock, and the at-construction validation of every string knob.
- **Bitwise parity** on the host (``device="cpu"``): a coalesced K-query
  batch answered through ONE window is bitwise-identical, column by column,
  to K sequential single-query engines — under churn, under
  ``arrival="first"`` and through the fused window driver; a mixed
  matvec/matmat/mapreduce trace under churn is exact against float64.
- **Serving edge cases**: idle loop, bounded-queue rejection, deadline
  expiry and miss, total preemption (requests survive), the asyncio front
  door and its shutdown.
- **The CLI**: ``python -m repro_torch.launch.serve_cli --device cpu``
  prints the same JSON snapshot as ``python -m repro.launch.serve_cli`` for
  the defaults, ``--mapreduce-every 3 --churn-at 8``, ``--fuse-steps 4``,
  ``--arrival first`` and ``--corruption-rate 0.1`` (the reference runs in
  one subprocess with 4 forced host devices).

The fleet is the reference's: N = 4, cyclic J = 3, S = 1, a 384 x 384
integer-valued matrix, ``block_rows = 16``. Tolerance: bitwise (exact
integer-grid data) and equal snapshots.
"""

import asyncio
import json
import os
from collections import deque

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import run_with_devices  # noqa: E402

from repro_torch.api import (  # noqa: E402
    ElasticEngine,
    EngineConfig,
    MapReduceRows,
    MatMat,
    MatVec,
    MatVecPowerIteration,
    Policy,
)
from repro_torch.core.elastic import ElasticEvent  # noqa: E402
from repro_torch.launch import serve_cli  # noqa: E402
from repro_torch.runtime.elastic_runner import (  # noqa: E402
    RunnerConfig,
    SyntheticSpeedClock,
    make_exact_matrix,
)
from repro_torch.serve import (  # noqa: E402
    AsyncElasticServer,
    Coalescer,
    ElasticServer,
    Request,
    ServeConfig,
    ServerMetrics,
    SyntheticClock,
)

BASE = [1000., 1400., 1900., 2600.]
X = make_exact_matrix(4 * 96, 0)
Q = X.shape[0]
X64 = X.astype(np.float64)
CLI_CASES = {
    "defaults": [],
    "mapreduce_churn": ["--mapreduce-every", "3", "--churn-at", "8"],
    "fuse4": ["--fuse-steps", "4"],
    "first": ["--arrival", "first"],
    "corruption": ["--corruption-rate", "0.1"],
}


def _req(rid, kind, operand, cols):
    return Request(rid=rid, kind=kind, operand=operand, cols=cols,
                   t_enqueue=0.0)


def mapreduce():
    return MapReduceRows(
        row_fn=lambda xb, w2: (xb.float() ** 2).sum(1, keepdim=True),
        reduce_fn=lambda mapped: float(mapped.sum(dtype=np.float64)),
        out_cols=1,
        ref_row_fn=lambda x64, _w: np.sum(x64 ** 2, axis=1, keepdims=True))


def server(mapreduce_lane=None, verify=None, segmented=None, **kw):
    return ElasticServer(
        X,
        Policy(placement="cyclic", replication=3, stragglers=1),
        EngineConfig(block_rows=16, verify=verify, segmented=segmented,
                     initial_speeds=tuple(BASE)),
        ServeConfig(**kw),
        mapreduce=mapreduce_lane,
        clock=SyntheticClock(),
        engine_clock=SyntheticSpeedClock(BASE, jitter_sigma=0.0, seed=0),
        n_machines=4, device="cpu")


# ---------------------------------------------------------------------- #
# Coalescer / metrics / clock units
# ---------------------------------------------------------------------- #
def test_coalescer_packs_fifo_into_fixed_width_operand():
    r = 8
    q = deque([
        _req(0, "matvec", np.ones(r, np.float32), 1),
        _req(1, "matmat", 2 * np.ones((r, 2), np.float32), 2),
        _req(2, "matvec", 3 * np.ones(r, np.float32), 1),
    ])
    batch = Coalescer(r, batch_cols=4).pack(q)
    assert not q
    assert batch.kind == "linear"
    assert [req.rid for req in batch.requests] == [0, 1, 2]
    assert batch.col_spans == [(0, 1), (1, 3), (3, 4)]
    assert batch.operand.shape == (r, 4)
    assert batch.operand.dtype == np.float32
    assert np.array_equal(batch.operand[:, 0], np.ones(r))
    assert np.array_equal(batch.operand[:, 1:3], 2 * np.ones((r, 2)))
    assert np.array_equal(batch.operand[:, 3], 3 * np.ones(r))


def test_coalescer_pads_unused_columns_with_zeros():
    q = deque([_req(0, "matvec", np.ones(4, np.float32), 1)])
    batch = Coalescer(4, batch_cols=3).pack(q)
    assert batch.operand.shape == (4, 3)
    assert np.array_equal(batch.operand[:, 1:], np.zeros((4, 2)))


def test_coalescer_overflow_ends_batch_without_reordering():
    q = deque([
        _req(0, "matvec", np.ones(4, np.float32), 1),
        _req(1, "matmat", np.ones((4, 2), np.float32), 2),
        _req(2, "matvec", np.ones(4, np.float32), 1),
    ])
    c = Coalescer(4, batch_cols=2)
    got = [c.pack(q) for _ in range(3)]
    assert [[r.rid for r in b.requests] for b in got] == [[0], [1], [2]]
    assert got[0].batch_id < got[1].batch_id < got[2].batch_id


def test_coalescer_refuses_to_merge_mapreduce_with_linear():
    q = deque([
        _req(0, "matvec", np.ones(4, np.float32), 1),
        _req(1, "mapreduce", None, 0),
        _req(2, "matvec", np.ones(4, np.float32), 1),
    ])
    c = Coalescer(4, batch_cols=8)
    b0, b1, b2 = c.pack(q), c.pack(q), c.pack(q)
    assert b0.kind == "linear" and [x.rid for x in b0.requests] == [0]
    assert b1.kind == "mapreduce" and [x.rid for x in b1.requests] == [1]
    assert b1.operand is None
    assert b2.kind == "linear" and [x.rid for x in b2.requests] == [2]
    assert c.pack(q) is None


def test_metrics_snapshot_percentiles_and_goodput():
    m = ServerMetrics()
    lats = [0.1, 0.2, 0.3, 0.4]
    m.on_enqueue(0.0, depth=1)
    for i, lat in enumerate(lats):
        m.on_complete(lat, t_complete=1.0 + i, missed=(i == 3))
    m.on_reject()
    m.on_expire()
    m.on_idle()
    m.on_batch(3, 4)
    snap = m.snapshot()
    assert snap["requests"] == {
        "enqueued": 1, "completed": 4, "rejected": 1, "expired": 1,
        "deadline_missed": 1}
    assert snap["latency"]["n"] == 4
    assert snap["latency"]["p50"] == pytest.approx(
        float(np.percentile(lats, 50)))
    assert snap["latency"]["p99"] == pytest.approx(
        float(np.percentile(lats, 99)))
    assert snap["goodput_rps"] == pytest.approx(3 / 4.0)
    assert snap["batches"]["count"] == 1
    assert snap["batches"]["mean_requests"] == 3.0


def test_synthetic_clock_is_explicit_and_monotonic():
    clk = SyntheticClock(5.0)
    assert clk.now() == 5.0
    clk.advance(1.5)
    assert clk.now() == 6.5
    with pytest.raises(ValueError, match="backwards"):
        clk.advance(-1.0)


@pytest.mark.parametrize("build,match", [
    (lambda: EngineConfig(arrival="sometimes"), r"arrival.*barrier.*'sometimes'"),
    (lambda: EngineConfig(replan="p2p"), r"replan.*central.*'p2p'"),
    (lambda: EngineConfig(verify="bitwise"), r"verify.*exact.*'bitwise'"),
    (lambda: EngineConfig(segmented="fast"), r"segmented.*cuda.*'fast'"),
    (lambda: RunnerConfig(arrival="last"), r"arrival.*first.*'last'"),
    (lambda: RunnerConfig(replan="none"), r"replan.*decentral.*'none'"),
    (lambda: RunnerConfig(verify="yes"), r"verify.*allclose.*'yes'"),
    (lambda: RunnerConfig(segmented="gpu"), r"segmented.*ref.*'gpu'"),
    (lambda: Policy(placement="ring"), r"placement.*cyclic.*'ring'"),
    (lambda: Policy(replan="gossip"), r"replan.*decentral.*'gossip'"),
    (lambda: ElasticEngine(MatVec(), backend="gpu", n_machines=4),
     r"backend.*simulate"),
    (lambda: ServeConfig(batch_cols=0), "batch_cols"),
    (lambda: ServeConfig(max_queue=0), "max_queue"),
    (lambda: ServeConfig(degraded="drop"), "degraded"),
    (lambda: ServeConfig(verify_results="sample"), "verify_results"),
], ids=["engine_arrival", "engine_replan", "engine_verify",
        "engine_segmented", "runner_arrival", "runner_replan",
        "runner_verify", "runner_segmented", "policy_placement",
        "policy_replan", "engine_backend", "serve_batch_cols",
        "serve_max_queue", "serve_degraded", "serve_verify_results"])
def test_string_knobs_rejected_at_construction(build, match):
    with pytest.raises(ValueError, match=match):
        build()


# ---------------------------------------------------------------------- #
# Reentrant engine + completion observers
# ---------------------------------------------------------------------- #
def _engine(workload, arrival="barrier", fuse=1, segmented=None, **cfg):
    return ElasticEngine(
        workload,
        Policy(placement="cyclic", replication=3, stragglers=1),
        EngineConfig(block_rows=16, arrival=arrival, fuse_steps=fuse,
                     segmented=segmented, initial_speeds=tuple(BASE), **cfg),
        backend="device", n_machines=4,
        clock=SyntheticSpeedClock(BASE, jitter_sigma=0.0, seed=0),
        device="cpu")


@pytest.mark.parametrize("segmented", [None, "auto"])
def test_coalesced_batch_bitwise_equals_sequential_runs(segmented):
    """K queries answered as columns of ONE window vs K fresh engines
    answering them one at a time — same policy, churn event and clocks.
    Bitwise per column under barrier AND first-arrival, stepwise and
    through the fused window driver; first-arrival realizes the same
    straggler set at any operand width."""
    rng = np.random.default_rng(1)
    K = 4
    W = rng.integers(-3, 4, size=(Q, K)).astype(np.float32)
    ev = ElasticEvent(step=0, preempted=(1,), arrived=(),
                      available=(0, 2, 3))
    for arrival in ("barrier", "first"):
        for fuse in (1, 4):
            eng = _engine(MatMat(), arrival, fuse, segmented)
            assert eng.prepare(X) is eng.runner
            Y, reps = eng.submit(W, event=ev)
            assert reps[0].jit_cache_size == 1 and len(reps) == 1
            for j in range(K):
                e2 = _engine(MatMat(), arrival, fuse, segmented)
                e2.prepare(X)
                yj, rj = e2.submit(W[:, j:j + 1], event=ev)
                assert np.asarray(Y)[:, j].tobytes() == \
                    np.asarray(yj)[:, 0].tobytes(), (arrival, fuse, j)
                assert rj[0].straggled == reps[0].straggled
            if arrival == "first":
                assert reps[0].straggled


def test_prepare_is_idempotent_and_refuses_new_data():
    eng = _engine(MatMat())
    with pytest.raises(RuntimeError, match="prepare"):
        eng.submit(np.ones((Q, 1), np.float32))
    r = eng.prepare(X)
    assert eng.prepare() is r
    with pytest.raises(ValueError, match="already staged"):
        eng.prepare(X)
    sim = ElasticEngine(MatVec(), n_machines=4)
    with pytest.raises(ValueError, match="backend='device'"):
        sim.prepare(X)


@pytest.mark.parametrize("arrival,fuse", [("barrier", 1), ("first", 1),
                                          ("barrier", 4), ("first", 4)])
def test_completion_callbacks_see_every_step_once_in_order(arrival, fuse):
    """Observers get ``[report]`` per stepwise or first-arrival step and
    a window's per-active-step reports on the fused path: every executed
    step exactly once, in step order; a removed observer sees nothing."""
    eng = _engine(MatVecPowerIteration(seed=0), arrival, fuse)
    runner = eng.prepare(X)
    seen, calls, gone = [], [], []
    cb = lambda reps: (seen.extend(reps), calls.append(len(reps)))  # noqa
    runner.add_completion_callback(cb)
    runner.add_completion_callback(gone.extend)
    runner.remove_completion_callback(gone.extend)
    res = eng.run(n_steps=7)
    assert [r.step for r in seen] == list(range(1, 8))
    assert seen == res.reports and not gone
    assert calls == ([1] * 7 if fuse == 1 else [4, 3])


@pytest.mark.parametrize("fuse", [1, 4])
def test_mapreduce_segmented_default_equals_per_block(fuse):
    """The base ``segmented_fn`` (gather + ``torch.vmap`` of the row
    function) assembles each row exactly once under churn and stragglers:
    bitwise the per-block loop, and exact against float64."""
    events = [ElasticEvent(step=i, preempted=p, arrived=a, available=v)
              for i, (p, a, v) in enumerate([
                  ((), (), (0, 1, 2, 3)), ((1,), (), (0, 2, 3)),
                  ((), (), (0, 2, 3)), ((), (1,), (0, 1, 2, 3)),
                  ((), (), (0, 1, 2, 3))])]
    out = {}
    for seg in (None, "auto"):
        eng = _engine(mapreduce(), "first", fuse, seg, verify="exact")
        eng.prepare(X)
        out[seg] = [eng.submit(None, event=e)[0] for e in events]
    assert out[None] == out["auto"]
    assert all(v == float(np.sum(X64 ** 2)) for v in out[None])


# ---------------------------------------------------------------------- #
# The server
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("segmented", [None, "auto"])
def test_server_serves_mixed_traffic_under_churn_bitwise(segmented):
    """A mixed matvec/matmat/mapreduce trace with a preemption and a
    re-arrival mid-stream: every response exact against float64, both
    lanes hold one program across the churn, the metrics account for
    every request."""
    rng = np.random.default_rng(3)
    srv = server(mapreduce(), verify="exact", segmented=segmented,
                 batch_cols=4, max_queue=32)
    expect, collected = {}, []
    for i in range(12):
        if i == 4:
            srv.feed_event(preempted=(1,))
        if i == 8:
            srv.feed_event(arrived=(1,))
        if i % 4 == 3:
            srv.submit("mapreduce")
            expect[i] = ("mapreduce", None)
        elif i % 4 == 2:
            w = rng.integers(-3, 4, size=(Q, 2)).astype(np.float32)
            srv.submit("matmat", w)
            expect[i] = ("matmat", w)
        else:
            w = rng.integers(-3, 4, size=Q).astype(np.float32)
            srv.submit("matvec", w)
            expect[i] = ("matvec", w)
        collected.extend(srv.poll())
    collected.extend(srv.drain())
    resps = {r.rid: r for r in collected}
    assert sorted(resps) == list(range(12))
    snap = srv.metrics_snapshot()
    assert snap["requests"]["enqueued"] == 12
    assert snap["requests"]["completed"] == 12
    assert snap["requests"]["rejected"] == snap["requests"]["expired"] == 0
    for name, lane in snap["lanes"].items():
        assert lane["jit_cache_size"] == 1, (name, lane)
        assert lane["churn_events"] >= 1, (name, lane)
    for rid, r in resps.items():
        kind, w = expect[rid]
        assert r.status == "ok"
        if kind == "mapreduce":
            assert r.result == float(np.sum(X64 ** 2))
        else:
            assert np.array_equal(r.result.astype(np.float64), X64 @ w)


def test_serving_edge_cases():
    """Idle loop, bounded-queue rejection, deadline expiry before dispatch,
    deadline missed mid-window, total preemption (requests survive and
    complete after re-arrival), and the async front door."""
    w = np.ones(Q, np.float32)
    srv = server(batch_cols=2, max_queue=4)
    for _ in range(3):
        assert srv.poll() == []
    snap = srv.metrics_snapshot()
    assert snap["queue"]["idle_polls"] == 3 and snap["windows"]["count"] == 0

    srv = server(batch_cols=2, max_queue=2)
    assert srv.submit("matvec", w).admitted
    assert srv.submit("matvec", w).admitted
    t3 = srv.submit("matvec", w)
    assert not t3.admitted and t3.retry_after > 0
    assert srv.metrics_snapshot()["requests"]["rejected"] == 1
    assert srv.queue_depth == 2
    srv.drain()
    assert srv.submit("matvec", w).admitted

    srv = server(batch_cols=2, max_queue=4)
    srv.submit("matvec", w, deadline=0.5)
    srv.clock.advance(1.0)
    assert [r.status for r in srv.poll()] == ["expired"]
    snap = srv.metrics_snapshot()
    assert snap["requests"]["expired"] == 1 and snap["windows"]["count"] == 0

    srv = server(batch_cols=2, max_queue=4)
    srv.submit("matvec", w, deadline=1e-6)
    resps = srv.drain()
    assert len(resps) == 1 and resps[0].status == "ok"
    assert resps[0].deadline_missed
    assert np.array_equal(resps[0].result.astype(np.float64), X64 @ w)
    snap = srv.metrics_snapshot()
    assert snap["requests"]["deadline_missed"] == 1
    assert snap["goodput_rps"] == 0.0

    srv = server(batch_cols=2, max_queue=4)
    srv.submit("matvec", w)
    srv.submit("matvec", 2 * w)
    srv.feed_event(preempted=(0, 1, 2, 3))
    assert not srv.serveable()
    assert srv.poll() == [] and srv.drain() == []
    assert srv.queue_depth == 2
    assert srv.metrics_snapshot()["queue"]["stalled_polls"] >= 1
    srv.feed_event(arrived=(0, 2))
    assert not srv.serveable()   # S = 1 needs two live holders per tile
    assert srv.poll() == [] and srv.queue_depth == 2
    srv.feed_event(arrived=(1,))
    assert srv.serveable()
    resps = srv.drain()
    assert sorted(r.rid for r in resps) == [0, 1]
    assert all(r.status == "ok" for r in resps)
    assert np.array_equal(resps[1].result.astype(np.float64), X64 @ (2 * w))
    with pytest.raises(ValueError, match="mapreduce lane is closed"):
        srv.submit("mapreduce")
    with pytest.raises(ValueError, match="batch_cols"):
        srv.submit("matmat", np.ones((Q, 3), np.float32))

    asrv = AsyncElasticServer(server(batch_cols=4, max_queue=8))

    async def drive():
        loop_task = asyncio.ensure_future(asrv.run())
        r1, r2 = await asyncio.gather(
            asrv.request("matvec", w), asrv.request("matvec", 3 * w))
        asrv.close()
        await loop_task
        return r1, r2

    r1, r2 = asyncio.run(drive())
    assert r1.status == r2.status == "ok"
    assert np.array_equal(r2.result.astype(np.float64), X64 @ (3 * w))


def test_async_close_fails_all_pending_waiters():
    """close() resolves EVERY pending waiter with a terminal "shutdown"
    response at once, and a request after close resolves the same way
    without touching the queue."""
    srv = server(batch_cols=4)
    srv.feed_event(preempted=[2, 3])   # unserveable: requests pend forever

    async def main():
        asrv = AsyncElasticServer(srv, idle_sleep=0.0)
        loop_task = asyncio.ensure_future(asrv.run())
        reqs = [asyncio.ensure_future(asrv.request("matvec", np.ones(
            Q, np.float32))) for _ in range(3)]
        await asyncio.sleep(0.05)
        assert not any(r.done() for r in reqs)
        asrv.close()
        resps = await asyncio.wait_for(asyncio.gather(*reqs), timeout=2)
        assert [r.status for r in resps] == ["shutdown"] * 3
        await asyncio.wait_for(loop_task, timeout=2)
        assert asrv._waiters == {}
        post = await asrv.request("matvec", np.zeros(Q, np.float32))
        assert post.status == "shutdown"
        assert srv.queue_depth == 3

    asyncio.run(main())


def test_exact_window_audit_catches_what_the_tolerance_misses():
    """At the paper's 6000 x 6000 size the tolerance audit
    (``verify_results="always"``, the reference's) passes a corrupted
    window — the shift of ``corrupt_result`` is below ``1e-3 * Σ|X|·|w|``
    — and the reference's checker does the same; the exact audit
    (``"exact"``, integer-grid data) refuses it. The CLI's corruption runs
    use the exact audit."""
    from repro_torch.faults.integrity import IntegrityChecker, corrupt_result

    x = make_exact_matrix(6000, 0)
    rng = np.random.default_rng(0)
    w = np.zeros((6000, 8), np.float32)
    w[:, 0] = rng.integers(-3, 4, 6000)
    y = (x.astype(np.float64) @ w).astype(np.float32)
    corrupt_result(y, 5)
    assert IntegrityChecker(x, block_rows=20).check_output(0, y, w) is False
    assert IntegrityChecker(x, block_rows=20, exact=False).check_output(
        0, y, w) is True
    ref = pytest.importorskip("repro.faults.integrity")
    assert ref.IntegrityChecker(x, block_rows=20, exact=False).check_output(
        0, y, w) is True


def test_server_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ElasticServer(X, Policy(placement="cyclic", replication=3),
                      EngineConfig(block_rows=16), n_machines=4)


# ---------------------------------------------------------------------- #
# The CLI against the reference's
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def reference_cli(tmp_path_factory):
    pytest.importorskip("jax")
    d = tmp_path_factory.mktemp("serve_cli")
    code = f"""
        import json
        from repro.launch import serve_cli
        out = {{name: serve_cli.main(args)
                for name, args in {CLI_CASES!r}.items()}}
        with open({str(d / "ref.json")!r}, "w") as f:
            json.dump(out, f)
        print("done")
    """
    assert "done" in run_with_devices(code, n_devices=4)
    with open(d / "ref.json") as f:
        return json.load(f)


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_serve_cli_json_equals_reference(reference_cli, case, capsys):
    snap = serve_cli.main(CLI_CASES[case] + ["--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == snap
    # Through JSON on both sides, so floats compare as printed.
    assert json.loads(json.dumps(snap)) == reference_cli[case]
    assert snap["responses"]["ok"] > 0


def test_serve_cli_segmented_and_paper_fleet():
    """``--segmented auto`` serves the same trace with the same snapshot
    as the per-block mode; ``--paper`` builds the §V fleet
    (``configs/usec_paper.py``) and every response is exact."""
    from repro_torch.configs import usec_paper

    args = ["--device", "cpu", "--mapreduce-every", "3", "--churn-at", "8"]
    assert serve_cli.main(args + ["--segmented", "auto"]) == \
        serve_cli.main(args)
    a = serve_cli.parse_args(args + ["--paper", "--dim", "768",
                                     "--block-rows", "16",
                                     "--requests", "12"])
    srv, x = serve_cli.build_server(a)
    assert srv.placement.n_machines == usec_paper.N_MACHINES
    record = {}
    resps = serve_cli.run_trace(srv, a, record)
    x64 = x.astype(np.float64)
    assert len(resps) == 12 and all(r.status == "ok" for r in resps)
    for r in resps:
        kind, w = record[r.rid]
        want = (float(np.sum(x64 ** 2)) if kind == "mapreduce"
                else x64 @ w)
        assert np.array_equal(np.asarray(r.result, np.float64), want)
    assert os.path.basename(serve_cli.__file__) == "serve_cli.py"
