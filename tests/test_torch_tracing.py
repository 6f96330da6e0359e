"""Host spans of the engine, runner and server (``runtime.tracing``).

Off, a span is one shared object that records nothing. A :class:`Recorder`
keeps every span of a CPU engine or server run: one ``runner.step``,
``runner.dispatch`` and ``workload.update`` per ``engine.step``, every span
inside its parent, self times adding up to totals, solve and probe spans
counted as the runner counts them, one ``serve.queued`` per answered query
under its window. Under ``torch.profiler`` the kineto host events carry the
same names with the same nesting, and recording changes no output bit.
"""

import itertools
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import (  # noqa: E402
    ElasticEngine,
    EngineConfig,
    MatVecPowerIteration,
    Policy,
)
from repro_torch.core.elastic import MarkovChurnTrace  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    SyntheticSpeedClock,
    make_exact_matrix,
    tracing,
)
from repro_torch.runtime.tracing import Recorder, span  # noqa: E402
from repro_torch.serve import ElasticServer, ServeConfig  # noqa: E402

N, DIM, STEPS = 6, 1200, 12
SPEEDS = [1000.0 * s for s in (1, 2, 4, 8, 16, 32)]
# (placement, S, arrival, forced stragglers a step): the benchmark's three
# power-iteration paths at a small X.
MODES = {
    "cyclic-barrier": ("cyclic", 0, "barrier", 0),
    "man-first": ("man", 1, "first", 0),
    "man-barrier": ("man", 1, "barrier", 1),
}


def _engine(kind, s_tol, arrival, fuse=1, precompile=True):
    eng = ElasticEngine(
        MatVecPowerIteration(seed=0),
        Policy(placement=kind, replication=3, stragglers=s_tol),
        EngineConfig(block_rows=20, segmented="ref", arrival=arrival,
                     fuse_steps=fuse, precompile_neighbors=precompile),
        backend="device", n_machines=N,
        clock=SyntheticSpeedClock(SPEEDS, jitter_sigma=0.03, seed=0),
        device="cpu")
    eng.prepare(make_exact_matrix(DIM, 0))
    return eng


def _run(eng, s_tol, forced, steps=STEPS, seed=3):
    """One churned run of ``steps`` steps: a Markov draw a step (the
    benchmark's rates), ``forced`` stragglers drawn a step."""
    tr = MarkovChurnTrace(N, 0.2, 0.6, seed=seed, placement=eng.placement,
                          min_holders=1 + s_tol)
    rng = np.random.default_rng(seed)

    def pick(step, membership):
        mem = sorted(membership)
        if len(mem) <= forced:
            return ()
        return tuple(int(m) for m in rng.choice(mem, forced, replace=False))

    return eng.run(None, n_steps=steps,
                   events=(tr.step() for _ in itertools.count()),
                   straggler_sets=pick if forced else None)


def _children(spans):
    kids = {i: [] for i in range(len(spans))}
    for i, s in enumerate(spans):
        if s[2] is not None:
            kids[s[2]].append(i)
    return kids


def _check_tree(rec):
    """Every span closed and inside its parent; siblings do not overlap;
    the summary's self times add up to the roots' totals."""
    spans = rec.spans
    assert spans and all(s[4] is not None and s[4] >= s[3] for s in spans)
    kids = _children(spans)
    for i, s in enumerate(spans):
        if s[2] is not None:
            p = spans[s[2]]
            assert p[3] <= s[3] and s[4] <= p[4], (s[0], p[0])
        ks = sorted(kids[i], key=lambda k: spans[k][3])
        for a, b in zip(ks, ks[1:]):
            assert spans[a][4] <= spans[b][3]
    summ = rec.summary()["spans"]
    roots = sum(s[4] - s[3] for s in spans if s[2] is None)
    self_sum = sum(v["self_s"] for k, v in summ.items()
                   if k != "serve.queued")
    assert self_sum == pytest.approx(1e-9 * roots, rel=1e-9, abs=1e-12)
    for name, v in summ.items():
        assert v["count"] == sum(s[0] == name for s in spans) or \
            name == "serve.queued"
        assert 0.0 <= v["self_s"] <= v["total_s"] + 1e-12


def test_off_span_is_one_shared_object_that_records_nothing():
    assert not tracing.recording()
    a, b = span("runner.step", 1), span("serve.poll")
    assert a is b
    with a as got:
        assert got is a
    assert tracing.stamp() is None
    rec = Recorder()
    tracing.record_async("serve.queued", 0, 1)   # no recorder: dropped
    with span("engine.run"):
        pass
    assert rec.spans == [] and rec.async_spans == []
    assert rec.summary() == {"spans": {}, "counters": {}}


def test_one_recorder_at_a_time_and_no_device_allocs_on_the_cpu():
    rec = Recorder().start()
    try:
        with pytest.raises(RuntimeError):
            Recorder().start()
        assert tracing.recording()
        assert span("a") is not span("a")
    finally:
        rec.stop()
    assert not tracing.recording()
    assert rec.summary()["counters"] == {"num_device_alloc": 0}


def test_each_thread_nests_its_own_spans():
    rec = Recorder()
    go = threading.Event()

    def other():
        go.wait(5)
        with span("b.outer", "t2"):
            with span("b.inner", "t2"):
                pass

    th = threading.Thread(target=other)
    with rec:
        th.start()
        with span("a.outer", "t1"):
            go.set()
            th.join(5)
            with span("a.inner", "t1"):
                pass
    assert not th.is_alive()
    names = {s[0]: s for s in rec.spans}
    sp = rec.spans
    assert sp[names["a.inner"][2]][0] == "a.outer"
    assert sp[names["b.inner"][2]][0] == "b.outer"
    assert names["b.outer"][2] is None


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_run_spans_nest_and_add_up(mode):
    kind, s_tol, arrival, forced = MODES[mode]
    eng = _engine(kind, s_tol, arrival)
    _run(eng, s_tol, forced, steps=2)          # plans, caches warm
    runner = eng.runner
    c0 = (runner.plans_compiled, runner.plans_precompiled,
          runner.probe_solves)
    rec = Recorder()
    with rec:
        res = _run(eng, s_tol, forced, seed=5)
    _check_tree(rec)
    spans = rec.spans
    kids = _children(spans)
    runs = [i for i, s in enumerate(spans) if s[0] == "engine.run"]
    assert len(runs) == 1 and spans[runs[0]][2] is None
    steps = [i for i, s in enumerate(spans) if s[0] == "engine.step"]
    assert len(steps) == STEPS == len(res.reports)
    for i in steps:
        assert spans[i][2] == runs[0]
        names = [spans[k][0] for k in kids[i]]
        assert names.count("runner.step") == 1
        assert names.count("workload.update") == 1
        rs = kids[i][names.index("runner.step")]
        below = [spans[k][0] for k in kids[rs]]
        assert below.count("runner.dispatch") == 1
        assert below.count("runner.adopt") == 1
        assert below.count("runner.account") == 1
        assert below.count("runner.fetch") == 1
    count = {}
    for s in spans:
        count[s[0]] = count.get(s[0], 0) + 1
    assert count["runner.dispatch"] == count["runner.step"] == STEPS
    assert count.get("runner.gather", 0) == (STEPS if arrival == "first"
                                             else 0)
    # Solves are the plans compiled on the step path (the neighbours'
    # batch compile is runner.precompile's); probes every drift-gate LP.
    d = (runner.plans_compiled - c0[0], runner.plans_precompiled - c0[1],
         runner.probe_solves - c0[2])
    assert count.get("runner.solve", 0) == d[0] - d[1]
    assert count.get("runner.probe", 0) == d[2]
    assert d[0] > 0 or d[2] > 0, "churn should replan at least once"
    for i, s in enumerate(spans):
        if s[0] in ("runner.solve", "runner.probe"):
            assert spans[s[2]][0] == "runner.adopt"
        if s[0] in ("runner.ingest", "runner.adopt", "runner.dispatch"):
            assert spans[s[2]][0] == "runner.step"


def test_solves_equal_plans_compiled_without_precompile():
    eng = _engine("cyclic", 0, "barrier", precompile=False)
    runner = eng.runner
    c0 = (runner.plans_compiled, runner.probe_solves)
    with Recorder() as rec:
        _run(eng, 0, 0)
    names = [s[0] for s in rec.spans]
    assert names.count("runner.solve") == runner.plans_compiled - c0[0] > 0
    assert names.count("runner.probe") == runner.probe_solves - c0[1]
    assert "runner.precompile" not in names


def test_fused_window_holds_one_dispatch():
    eng = _engine("cyclic", 0, "barrier", fuse=4)
    with Recorder() as rec:
        res = _run(eng, 0, 0)
    _check_tree(rec)
    spans = rec.spans
    kids = _children(spans)
    wins = [i for i, s in enumerate(spans) if s[0] == "runner.window"]
    assert wins
    for i in wins:
        names = [spans[k][0] for k in kids[i]]
        assert names.count("runner.dispatch") == 1
        assert names.count("runner.fetch") == 1
        assert "runner.adopt" in names
    ups = [s for s in spans if s[0] == "workload.update"]
    assert len(ups) == len(res.reports) == STEPS


@pytest.mark.parametrize("mode", sorted(MODES))
def test_recording_changes_no_output_bit(mode):
    kind, s_tol, arrival, forced = MODES[mode]
    off = _run(_engine(kind, s_tol, arrival), s_tol, forced)
    with Recorder():
        on = _run(_engine(kind, s_tol, arrival), s_tol, forced)
    assert np.array_equal(off.result.eigvec, on.result.eigvec)
    assert off.result.residuals == on.result.residuals
    assert off.result.eigval == on.result.eigval
    for a, b in zip(off.reports, on.reports):
        assert (a.available, a.straggled, a.replanned, a.plan_cache_hit,
                a.waste) == (b.available, b.straggled, b.replanned,
                             b.plan_cache_hit, b.waste)


def _kineto_spans(prof, names):
    """(name, start, end) of the host events whose names are span names,
    and each one's innermost enclosing such event (index or None)."""
    evs = sorted(
        ((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
         for e in prof.profiler.kineto_results.events()
         if e.name() in names and e.device_type()
         == torch.autograd.DeviceType.CPU),
        key=lambda t: (t[0], -t[1]))
    parents = []
    open_ = []
    for i, (s, t, _) in enumerate(evs):
        while open_ and evs[open_[-1]][1] < t:
            open_.pop()
        parents.append(open_[-1] if open_ else None)
        open_.append(i)
    return evs, parents


@pytest.mark.parametrize("mode", ["cyclic-barrier", "man-first"])
def test_profiler_sees_the_same_spans_with_the_same_nesting(mode):
    from torch.profiler import ProfilerActivity, profile

    kind, s_tol, arrival, forced = MODES[mode]
    eng = _engine(kind, s_tol, arrival)
    _run(eng, s_tol, forced, steps=2)
    rec = Recorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec:
            _run(eng, s_tol, forced, steps=6)
    spans = rec.spans
    names = {s[0] for s in spans}
    evs, parents = _kineto_spans(prof, names)
    assert sorted(e[2] for e in evs) == sorted(s[0] for s in spans)
    # Both lists in opening order: the same sequence of names, and each
    # span's parent has the same name in both.
    order = sorted(range(len(spans)), key=lambda i: spans[i][3])
    assert [spans[i][0] for i in order] == [e[2] for e in evs]
    for k, i in enumerate(order):
        p_rec = spans[i][2]
        p_kin = parents[k]
        assert (None if p_rec is None else spans[p_rec][0]) == \
            (None if p_kin is None else evs[p_kin][2])


def _server(fuse=1, fault_injector=None):
    return ElasticServer(
        make_exact_matrix(DIM, 0),
        Policy(placement="cyclic", replication=3, stragglers=0),
        EngineConfig(block_rows=20, segmented="ref", fuse_steps=fuse),
        ServeConfig(batch_cols=8, max_queue=256),
        engine_clock=SyntheticSpeedClock(SPEEDS, jitter_sigma=0.03, seed=0),
        n_machines=N, fault_injector=fault_injector, device="cpu")


def _check_queued(rec, ok):
    """One ``serve.queued`` per answered request, tagged with its rid,
    under the ``serve.respond`` of the window that answered it, and ending
    inside that window's ``serve.dispatch``."""
    spans, queued = rec.spans, rec.async_spans
    assert sorted(q[1] for q in queued) == sorted(r.rid for r in ok)
    window = {r.rid: r.batch_id for r in ok}
    sent = {}
    for s in spans:
        if s[0] == "serve.dispatch":
            sent.setdefault(s[1], []).append(s)
    for name, rid, parent, t0, t1 in queued:
        assert name == "serve.queued" and t1 >= t0
        p = spans[parent]
        assert p[0] == "serve.respond" and p[1] == window[rid]
        d = [s for s in sent[window[rid]] if s[2] == p[2]]
        assert len(d) == 1 and d[0][3] <= t1 <= d[0][4] <= p[3]


@pytest.mark.parametrize("fuse", [1, 2])
def test_served_queries_wait_under_their_window(fuse):
    srv = _server(fuse)
    rng = np.random.default_rng(0)
    ops = [np.round(rng.standard_normal(DIM) * 4) / 4 for _ in range(20)]
    srv.submit("matvec", ops[0])
    srv.drain()                               # warm
    got = []
    with Recorder() as rec:
        for k, w in enumerate(ops):
            srv.submit("matvec", w)
            if k % 7 == 6:
                srv.feed_event(preempted=(k % N,))
                got += srv.poll()
                srv.feed_event(arrived=(k % N,))
        got += srv.drain()
    ok = [r for r in got if r.status == "ok"]
    assert len(ok) == len(ops)
    _check_tree(rec)
    spans = rec.spans
    queued = rec.async_spans
    assert sorted(q[1] for q in queued) == sorted(r.rid for r in ok)
    _check_queued(rec, ok)
    subs = [s for s in spans if s[0] == "serve.submit"]
    assert len(subs) == len(ops)
    assert {s[1] for s in subs} == {r.rid for r in ok}
    kids = _children(spans)
    polls = [i for i, s in enumerate(spans) if s[0] == "serve.poll"]
    dispatching = [i for i in polls
                   if "serve.dispatch" in [spans[k][0] for k in kids[i]]]
    assert len(dispatching) == len({r.batch_id for r in ok})
    for i in dispatching:
        names = [spans[k][0] for k in kids[i]]
        assert names.count("serve.pack") == 1
        assert names.count("serve.respond") == 1
        d = kids[i][names.index("serve.dispatch")]
        below = [spans[k][0] for k in kids[d]]
        assert below.count("runner.window" if fuse > 1
                           else "runner.step") == 1
        assert below.count("workload.update") == 1
    summ = rec.summary()["spans"]
    assert summ["serve.queued"]["count"] == len(ok)
    assert summ["serve.queued"]["self_s"] == pytest.approx(
        summ["serve.queued"]["total_s"])


def test_a_requeued_query_waits_once():
    """An uncovered fault aborts a window's dispatch and requeues its
    queries; each still gets one ``serve.queued``, up to the dispatch that
    answers it."""
    from repro_torch.faults import ChaosPlan, FaultInjector, FaultSpec

    inj = FaultInjector(ChaosPlan([FaultSpec("result_drop", 2, worker=1)]))
    srv = _server(fault_injector=inj)
    rng = np.random.default_rng(1)
    ops = [np.round(rng.standard_normal(DIM) * 4) / 4 for _ in range(20)]
    srv.submit("matvec", ops[0])
    srv.drain()                               # warm: step 0
    with Recorder() as rec:
        for w in ops:
            srv.submit("matvec", w)
        got = srv.drain()
    ok = [r for r in got if r.status == "ok"]
    assert len(ok) == len(ops) and len(inj.log) == 1
    sent = [s for s in rec.spans if s[0] == "serve.dispatch"]
    assert len(sent) == len({r.batch_id for r in ok}) + 1
    _check_tree(rec)
    _check_queued(rec, ok)


def test_span_decorator_tags_with_an_attribute_at_the_call():
    class Runner:
        _step = 4

        @tracing.traced("runner.step", "_step")
        def step(self, k):
            """Doc."""
            self._step += k
            return self._step

    r = Runner()
    assert Runner.step.__doc__ == "Doc." and Runner.step.__name__ == "step"
    assert r.step(1) == 5                     # off: nothing recorded
    with Recorder() as rec:
        assert r.step(2) == 7
    assert [(s[0], s[1]) for s in rec.spans] == [("runner.step", 5)]


def test_the_profiler_flag_the_gate_reads_flips_with_a_session():
    """``span`` reads torch's module flag ``_is_profiler_enabled`` to know
    that a profiler runs; it must exist and be True only inside a
    session."""
    from torch.autograd import profiler

    assert profiler._is_profiler_enabled is False
    assert span("runner.step") is span("serve.poll")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiler._is_profiler_enabled is True
        assert span("runner.step") is not span("runner.step")
    assert profiler._is_profiler_enabled is False


def test_the_smokes_device_time_leaves_out_the_spans_device_ranges():
    """Under a profiler, a span that launches kernels also has a
    device-side user-annotation row as long as its whole range; the card
    smoke's device sums take kernels and copies only."""
    import importlib.util
    import os
    import types

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    def row(key, dev, us, annot):
        return types.SimpleNamespace(
            key=key, device_type=f"DeviceType.{dev}", count=1,
            self_device_time_total=us, is_user_annotation=annot)

    rows = [row("segmented_kernel<1>", "CUDA", 100.0, False),
            row("Memcpy DtoH (Device -> Pageable)", "CUDA", 10.0, False),
            row("runner.dispatch", "CUDA", 900.0, True),
            row("aten::copy_", "CPU", 10.0, False)]
    prof = types.SimpleNamespace(key_averages=lambda: rows)
    assert [r.key for r in smoke.device_rows(prof)] == [
        "segmented_kernel<1>", "Memcpy DtoH (Device -> Pageable)"]
    assert smoke._device_busy_ms(prof) == pytest.approx(0.11)
