"""First-arrival execution (``arrival="first"``) in the port against the JAX
package's.

The paper's §II master consumes the first N - S partials: each loaded
worker's partial is dispatched on its own (per-worker CUDA streams on the
card, in turn on the CPU), the clock's modeled arrival order picks the
realized slowest-S set, and each output row is gathered from its winning
holder. ``tests/test_torch_engine.py``'s setting: N = 4, a 768 x 768
integer-valued matrix, ``block_rows = 16``, its scripted churn, a
``SyntheticSpeedClock``, cyclic and MAN placements at S in {0, 1}. The
reference runs once, in one subprocess with 4 forced host devices, for
every case of this file; the port runs the same cases on the CPU in both
executor modes. Tolerance: bitwise (eigvec, residuals, outputs, plan
``seg_*`` arrays), equal (counts and report fields, modeled times included,
since the synthetic clock ignores the wall).

It mirrors ``tests/test_async.py``'s device cases: the reduction to the
barrier at S = 0, equality with the barrier on the realized sets injected,
the EWMA absorbing late arrivals, fused first-arrival windows against
stepwise, and the engine's ``arrival`` knob.
"""

import importlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from conftest import run_with_devices  # noqa: E402

N, DIM, STEPS = 4, 768, 6
BASE_SPEEDS = [1000.0, 1300.0, 1700.0, 2200.0]
SCRIPT = {0: ((3,), ()), 1: ((1,), (3,)), 2: ((), (1,)), 4: ((2,), ()),
          5: ((), (2,))}
GRID = [("cyclic", 0), ("man", 0), ("cyclic", 1), ("man", 1)]
MODES = [None, "auto"]
SEG_FIELDS = ("seg_tile", "seg_start", "seg_len", "seg_id", "n_valid")
REPORT_FIELDS = ("step", "available", "replanned", "plan_cache_hit",
                 "straggled", "waste", "jit_cache_size",
                 "modeled_completion", "measured")
RUNNER_STEPS = 8


def _mods(pkg):
    return (importlib.import_module(pkg + ".api"),
            importlib.import_module(pkg + ".core"),
            importlib.import_module(pkg + ".core.elastic"),
            importlib.import_module(pkg + ".runtime"))


def _observe_plans(pkg, runner):
    """Record ``runner.current_plan`` once per dispatch (a step, a window):
    the reference through its completion observer, the port (which has
    none) by wrapping its drivers."""
    plans = []
    if pkg == "repro":
        runner.add_completion_callback(
            lambda reps: plans.append(runner.current_plan))
        return plans
    for name in ("step", "step_window"):
        fn = getattr(runner, name)

        def observed(*a, _fn=fn, **k):
            out = _fn(*a, **k)
            plans.append(runner.current_plan)
            return out

        setattr(runner, name, observed)
    return plans


def run_cell(pkg, kind, s_tol, segmented=None, device=None, *,
             arrival="first", fuse_steps=1, inject=False, replan="central",
             kill=None, homogeneous=False, precompile=True, workload=None,
             steps=STEPS):
    """One engine run on the §V grid with package ``pkg`` ("repro" for the
    reference, in the subprocess; "repro_torch" for the port, here).
    ``inject`` forces one straggler per step (drawn from a seeded RNG);
    otherwise first-arrival derives the realized sets itself."""
    api, _, elastic, rt = _mods(pkg)
    rng = np.random.default_rng(1)

    def one_straggler(step, membership):
        return (int(rng.choice(membership)),) if len(membership) > 1 else ()

    kw = {} if device is None else {"device": device}
    if workload is None:
        wl = api.MatVecPowerIteration(seed=0)
    else:
        wl = api.MatMat(workload)
    eng = api.ElasticEngine(
        wl,
        api.Policy(placement=kind, replication=2 + s_tol, stragglers=s_tol,
                   homogeneous=homogeneous),
        api.EngineConfig(block_rows=16, verify="exact", segmented=segmented,
                         arrival=arrival, fuse_steps=fuse_steps,
                         replan=replan, precompile_neighbors=precompile),
        backend="device", n_machines=N,
        clock=rt.SyntheticSpeedClock(BASE_SPEEDS, jitter_sigma=0.03, seed=0),
        **kw)
    x = rt.make_exact_matrix(DIM, 0)
    runner = eng.prepare(x) if pkg == "repro" else eng._build_runner(x)
    eng._runner = runner
    plans = _observe_plans(pkg, runner)
    res = eng.run(None, n_steps=steps,
                  events=elastic.scripted_trace(N, SCRIPT),
                  straggler_sets=one_straggler if inject and s_tol else None,
                  kill_scheduler_at=kill)
    out = {
        "counts": np.array([res.churn_events, res.plans_compiled,
                            res.cache_hits, res.total_waste,
                            res.executor_cache_size,
                            runner.device_dispatches]),
        "killed": np.array(runner.scheduler_killed),
        "fault_records": np.asarray(
            [repr((r.spec, r.action, r.detail)) for r in res.fault_records]),
    }
    if workload is None:
        r = res.result
        out.update(eigvec=r.eigvec, residuals=np.asarray(r.residuals),
                   eigval=np.float64(r.eigval))
    else:
        out["result"] = np.asarray(res.result)
    for f in SEG_FIELDS:
        out[f] = np.stack([getattr(p, f) for p in plans])
    for f in REPORT_FIELDS:
        out["rep_" + f] = np.asarray(
            [repr(getattr(rep, f)) for rep in res.reports])
    return out


def runner_steps(pkg, arrival, s_tol, segmented=None, device=None,
                 inject=None, steps=RUNNER_STEPS, jitter=0.3):
    """The reference tests' runner-level loop: a Markov churn trace, a
    jittery synthetic clock (so first-arrival realizes stragglers), the
    host quantize_unit between steps. Returns (ys, reports, runner)."""
    _, core, elastic, rt = _mods(pkg)
    kw = {} if device is None else {"device": device}
    x = rt.make_exact_matrix(DIM, 0)
    placement = core.cyclic_placement(N, N, 2 + s_tol)
    runner = rt.ElasticRunner(
        x, placement,
        rt.RunnerConfig(block_rows=16, stragglers=s_tol, verify="exact",
                        arrival=arrival, segmented=segmented),
        initial_speeds=BASE_SPEEDS,
        clock=rt.SyntheticSpeedClock(BASE_SPEEDS, jitter_sigma=jitter,
                                     seed=0), **kw)
    trace = elastic.MarkovChurnTrace(N, p_preempt=0.2, p_arrive=0.6,
                                     min_available=1, seed=0,
                                     placement=placement,
                                     min_holders=1 + s_tol)
    w = rt.quantize_unit(np.random.default_rng(7).normal(size=DIM))
    ys, reps = [], []
    for i in range(steps):
        sets = None if inject is None else inject[i]
        y, rep = runner.step(w, event=trace.step(), stragglers=sets)
        ys.append(np.asarray(y))
        reps.append(rep)
        w = rt.quantize_unit(y)
    return ys, reps, runner


def fused_first_steps(pkg, fuse, window, segmented=None, device=None):
    """``tests/test_async.py``'s fused first-arrival loop: a homogeneous
    policy (plans depend on membership only), S = 1, first-arrival derived
    sets; ``fuse == 1`` steps, else windows of ``window`` active steps.
    Returns (ys, straggled, executor_cache_size)."""
    api, core, _, rt = _mods(pkg)
    kw = {} if device is None else {"device": device}
    runner = rt.ElasticRunner(
        rt.make_exact_matrix(DIM, 0), core.cyclic_placement(N, N, 3),
        rt.RunnerConfig(block_rows=16, arrival="first", fuse_steps=fuse,
                        segmented=segmented),
        initial_speeds=BASE_SPEEDS,
        clock=rt.SyntheticSpeedClock(BASE_SPEEDS, jitter_sigma=0.3, seed=0),
        workload=api.MatVecPowerIteration(),
        policy=api.Policy(stragglers=1, homogeneous=True), **kw)
    w = rt.quantize_unit(np.random.default_rng(7).normal(size=DIM))
    ys, sets = [], []
    if fuse == 1:
        for _ in range(RUNNER_STEPS):
            y, rep = runner.step(w)
            ys.append(np.asarray(y))
            sets.append(rep.straggled)
            w = rt.quantize_unit(y)
    else:
        for _ in range(RUNNER_STEPS // window):
            w, yk, _, reps = runner.step_window(
                w, straggler_sets=[None] * window)
            ys += [np.asarray(y) for y in yk]
            sets += [r.straggled for r in reps]
    return ys, sets, runner.executor_cache_size


def engine_matvec(pkg, arrival, segmented=None, device=None):
    """``tests/test_async.py``'s engine knob case: MatVec with an explicit
    operand under Markov churn, S = 1, derived realized sets."""
    api, core, elastic, rt = _mods(pkg)
    kw = {} if device is None else {"device": device}
    p = core.cyclic_placement(N, N, 3)
    w0 = rt.quantize_unit(np.random.default_rng(11).normal(size=DIM))
    trace = elastic.MarkovChurnTrace(N, p_preempt=0.2, p_arrive=0.6,
                                     min_available=1, seed=0, placement=p,
                                     min_holders=2)
    eng = api.ElasticEngine(
        api.MatVec(), api.Policy(stragglers=1),
        api.EngineConfig(verify="exact", arrival=arrival,
                         segmented=segmented),
        backend="device", placement=p,
        clock=rt.SyntheticSpeedClock(BASE_SPEEDS, jitter_sigma=0.3, seed=0),
        **kw)
    res = eng.run(rt.make_exact_matrix(DIM, 0), n_steps=6,
                  events=(trace.step() for _ in range(6)), operand=w0)
    return {"result": np.asarray(res.result),
            "straggled": np.asarray([repr(r.straggled)
                                     for r in res.reports]),
            "modeled": np.asarray([r.modeled_completion
                                   for r in res.reports]),
            "cache": np.array(res.executor_cache_size)}


def reference_outputs():
    """Every reference output this file compares with (run in the
    subprocess)."""
    out = {}
    for kind, s in GRID:
        out[f"first_{kind}{s}"] = run_cell("repro", kind, s)
    ys, reps, _ = runner_steps("repro", "first", 1)
    out["runner_first"] = {"ys": np.stack(ys), "straggled": np.asarray(
        [repr(r.straggled) for r in reps])}
    ys, sets, _ = fused_first_steps("repro", 1, 1)
    out["fused_first_k1"] = {"ys": np.stack(ys),
                             "straggled": np.asarray([repr(s) for s in sets])}
    out["engine_first"] = engine_matvec("repro", "first")
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("async_parity")
    code = f"""
        import sys
        import numpy as np
        sys.path.insert(0, {os.path.dirname(__file__)!r})
        from test_torch_async import reference_outputs
        for name, arrays in reference_outputs().items():
            np.savez("{d}/" + name + ".npz", **arrays)
        print("done")
    """
    assert "done" in run_with_devices(code, n_devices=N)
    return {f[:-4]: dict(np.load(os.path.join(d, f)))
            for f in os.listdir(d)}


def assert_cell_equal(got, want):
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), (k, got[k], want[k])


@pytest.mark.parametrize("segmented", MODES)
@pytest.mark.parametrize("kind,s_tol", GRID)
def test_first_arrival_matches_reference(reference, kind, s_tol, segmented):
    got = run_cell("repro_torch", kind, s_tol, segmented, "cpu")
    assert_cell_equal(got, reference[f"first_{kind}{s_tol}"])
    assert got["counts"][4] == 1          # executor_cache_size
    if s_tol:
        assert any(r != "()" for r in got["rep_straggled"])


@pytest.mark.parametrize("segmented", MODES)
@pytest.mark.parametrize("kind", ["cyclic", "man"])
def test_first_arrival_reduces_to_barrier_bitwise_at_s0(kind, segmented):
    """At S = 0 every segment has one holder: nothing can be skipped, and the
    winner gather reproduces the barrier combine bitwise, modeled
    completion included."""
    b = run_cell("repro_torch", kind, 0, segmented, "cpu", arrival="barrier")
    f = run_cell("repro_torch", kind, 0, segmented, "cpu")
    for k in ("eigvec", "residuals", "eigval", "rep_modeled_completion",
              "rep_measured", "rep_straggled") + SEG_FIELDS:
        assert f[k].tobytes() == b[k].tobytes(), k
    assert set(f["rep_straggled"].tolist()) == {"()"}
    assert f["counts"][4] == 1
    # one dispatch per loaded worker and step, against one per step
    assert f["counts"][5] > b["counts"][5] == STEPS


@pytest.mark.parametrize("segmented", MODES)
def test_first_arrival_runner_matches_reference(reference, segmented):
    ys, reps, runner = runner_steps("repro_torch", "first", 1, segmented,
                                    "cpu")
    want = reference["runner_first"]
    assert np.stack(ys).tobytes() == want["ys"].tobytes()
    assert [repr(r.straggled) for r in reps] == want["straggled"].tolist()
    assert runner.executor_cache_size == 1


@pytest.mark.parametrize("segmented", MODES)
def test_first_arrival_matches_barrier_with_realized_injected(segmented):
    """Replaying first-arrival's realized sets through the barrier path
    (injection) gives the same outputs bitwise: the masking is the same
    include weights, only the combine differs. First-arrival completion is
    the order statistic: never above the barrier's max, strictly below
    whenever a straggler was realized."""
    yf, rf, runner = runner_steps("repro_torch", "first", 1, segmented, "cpu")
    realized = [r.straggled for r in rf]
    assert any(realized)
    yb, _, _ = runner_steps("repro_torch", "barrier", 1, segmented, "cpu",
                            inject=realized)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(yf, yb))
    for r in rf:
        mx = max(r.measured.values())
        assert r.modeled_completion <= mx + 1e-15
        if r.straggled:
            assert r.modeled_completion < mx
    assert runner.executor_cache_size == 1


def test_first_arrival_absorbs_late_durations_into_ewma():
    _, rf, runner = runner_steps("repro_torch", "first", 1, None, "cpu",
                                 steps=4)
    for r in rf:
        assert set(r.straggled) <= set(r.measured)
    seed_speeds = np.asarray(BASE_SPEEDS, float) / runner.rows_per_tile
    straggled_ever = sorted({n for r in rf for n in r.straggled})
    assert straggled_ever
    runner.ingest_pending()
    s_hat = runner.scheduler.speeds
    assert [n for n in straggled_ever
            if abs(s_hat[n] - seed_speeds[n]) > 1e-12]


@pytest.mark.parametrize("segmented", MODES)
@pytest.mark.parametrize("window", [1, 4])
def test_fused_first_arrival_matches_stepwise(reference, window, segmented):
    """Fused windows compose with first-arrival: under a homogeneous policy
    the fused driver realizes the SAME straggler sets at assembly time and
    gives bitwise the stepwise outputs, for windows of 1 and 4 active steps
    (the driver always dispatches fuse_steps = 4)."""
    want = reference["fused_first_k1"]
    ys_s, sets_s, c_s = fused_first_steps("repro_torch", 1, 1, segmented,
                                          "cpu")
    assert np.stack(ys_s).tobytes() == want["ys"].tobytes()
    assert [repr(s) for s in sets_s] == want["straggled"].tolist()
    ys_f, sets_f, c_f = fused_first_steps("repro_torch", 4, window,
                                          segmented, "cpu")
    assert sets_f == sets_s
    assert np.stack(ys_f).tobytes() == np.stack(ys_s).tobytes()
    assert any(sets_s) and c_s == c_f == 1


@pytest.mark.parametrize("segmented", MODES)
def test_engine_arrival_knob_matches_reference(reference, segmented):
    got = engine_matvec("repro_torch", "first", segmented, "cpu")
    want = reference["engine_first"]
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k
    assert any(s != "()" for s in got["straggled"])
    bar = engine_matvec("repro_torch", "barrier", segmented, "cpu")
    assert set(bar["straggled"].tolist()) == {"()"}
    assert (got["modeled"] <= bar["modeled"] + 1e-15).all()
