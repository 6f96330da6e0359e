"""Unannounced failures in the port against the JAX package's: dispatch
faults, planning faults, ``dispatch_timeout`` and the engine's
demote → replan → re-execute loop.

``tests/test_faults.py``'s fleet: N = 4, cyclic J = 3, S = 1, a 384 x 384
integer-valued matrix, ``block_rows = 16``, a noiseless synthetic clock at
the initial speeds ``BASE``, 8 steps, ``verify="exact"`` at every step, no
forced stragglers (a fault on top of one would be uncovered). Every fault
kind at step 3 (dispatch kinds at worker 2) under the reference's reduced
grid ``(barrier, 1)`` and ``(first, 4)``, the full arrival x fuse grid for
``result_drop``, the uncovered crash at S = 0, a timed-out worker covered
and uncovered, and one seeded multi-fault schedule, each in both executor
modes. The reference runs once, in one subprocess with 4 forced host
devices, for every case of this file. Tolerance: bitwise (eigvec,
residuals), equal (per-report memberships, realized straggler sets and
measured workers; every fault record's step, kind, worker, action and
modeled detection latency; recoveries; integrity counters;
``executor_cache_size``).

``tests/test_torch_integrity.py`` reuses this file's harness for the
corruption kinds.
"""

import importlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from conftest import run_with_devices  # noqa: E402

N, DIM, STEPS = 4, 4 * 96, 8
BASE = [1000.0, 1400.0, 1900.0, 2600.0]
# dispatch_timeout fleet: the planner believes every worker runs at 1000,
# worker 0 crawls at 10, so its modeled duration is ~100x the others'.
EST = [1000.0] * 4
REAL = [10.0, 1000.0, 1000.0, 1000.0]
MODES = [None, "auto"]
GRID = [("barrier", 1), ("first", 4)]
FULL_GRID = [("barrier", 1), ("barrier", 4), ("first", 1), ("first", 4)]
INTEGRITY_KEYS = ("restaged", "quarantined", "repaired_rows",
                  "graylist_events", "checks", "sketch_failures",
                  "tile_audits")

KINDS = {
    "worker_crash": ([("worker_crash", 3, 2)], "masked", {}),
    "result_drop": ([("result_drop", 3, 2)], "masked", {}),
    "speed_report_loss": ([("speed_report_loss", 3, None)],
                          "report_dropped", {}),
    "stale_plan_table": ([("stale_plan_table", 3, None)], "invalidated", {}),
    "scheduler_kill": ([("scheduler_kill", 3, None)], "killed",
                       dict(replan="decentral")),
}
SEEDED_KINDS = ("worker_crash", "result_drop", "speed_report_loss",
                "stale_plan_table")


def engine(pkg, arrival="barrier", fuse=1, segmented=None, device=None,
           stragglers=1, verify_results="off", check="exact",
           speeds=None, real=None, replan="central", **cfg):
    api = importlib.import_module(pkg + ".api")
    rt = importlib.import_module(pkg + ".runtime")
    dev = {} if device is None else {"device": device}
    return api.ElasticEngine(
        api.MatVecPowerIteration(seed=0),
        api.Policy(placement="cyclic", replication=3, stragglers=stragglers,
                   replan=replan, verify_results=verify_results),
        api.EngineConfig(block_rows=16, verify=check, segmented=segmented,
                         initial_speeds=tuple(speeds or BASE),
                         arrival=arrival, fuse_steps=fuse, **cfg),
        backend="device", n_machines=N,
        clock=rt.SyntheticSpeedClock(real or BASE, jitter_sigma=0.0, seed=0),
        **dev)


def schedule(pkg, faults):
    """``faults``: a list of (kind, step, worker) triples, or ("seed", s,
    kinds) for ``ChaosPlan.generate(STEPS, N, n_faults=3, ...)``."""
    fl = importlib.import_module(pkg + ".faults")
    if faults is None:
        return None
    if faults[0] == "seed":
        return fl.ChaosPlan.generate(STEPS, N, n_faults=3, seed=faults[1],
                                     kinds=faults[2])
    return fl.ChaosPlan([fl.FaultSpec(k, s, worker=w) for k, s, w in faults])


def summarize(res):
    recs = [f"{r.spec.step}:{r.spec.kind}:{r.spec.worker}:{r.action}:"
            f"{r.detect_s!r}" for r in res.fault_records]
    return {
        "eigvec": res.result.eigvec,
        "residuals": np.asarray(res.result.residuals),
        "rep_available": np.asarray([repr(r.available)
                                     for r in res.reports]),
        "rep_straggled": np.asarray([repr(r.straggled)
                                     for r in res.reports]),
        "rep_measured": np.asarray([repr(sorted(r.measured))
                                    for r in res.reports]),
        "records": np.asarray(recs, dtype=str).reshape(-1),
        "counts": np.array([res.n_steps, res.recoveries,
                            res.executor_cache_size]),
        "integrity": np.array([res.integrity.get(k, 0)
                               for k in INTEGRITY_KEYS]),
    }


def run_case(pkg, faults=None, arrival="barrier", fuse=1, segmented=None,
             device=None, **kw):
    rt = importlib.import_module(pkg + ".runtime")
    eng = engine(pkg, arrival, fuse, segmented, device, **kw)
    res = eng.run(rt.make_exact_matrix(DIM, 0), n_steps=STEPS,
                  faults=schedule(pkg, faults))
    return summarize(res)


def cases():
    """Every case of this file: name -> run_case keyword arguments."""
    out = {}
    for arrival, fuse in FULL_GRID:
        g = f"{arrival}{fuse}"
        out[f"clean_{g}"] = dict(arrival=arrival, fuse=fuse)
        out[f"result_drop_{g}"] = dict(
            arrival=arrival, fuse=fuse, faults=KINDS["result_drop"][0])
    for arrival, fuse in GRID:
        g = f"{arrival}{fuse}"
        out[f"clean_decentral_{g}"] = dict(arrival=arrival, fuse=fuse,
                                           replan="decentral")
        for kind, (faults, _, kw) in KINDS.items():
            out[f"{kind}_{g}"] = dict(arrival=arrival, fuse=fuse,
                                      faults=faults, **kw)
        out[f"clean_s0_{g}"] = dict(arrival=arrival, fuse=fuse,
                                    stragglers=0)
        out[f"crash_s0_{g}"] = dict(arrival=arrival, fuse=fuse, stragglers=0,
                                    faults=[("worker_crash", 3, 2)])
        for s_tol in (0, 1):
            out[f"timeout_s{s_tol}_{g}"] = dict(
                arrival=arrival, fuse=fuse, stragglers=s_tol, speeds=EST,
                real=REAL, dispatch_timeout=1.0)
            out[f"untimed_s{s_tol}_{g}"] = dict(
                arrival=arrival, fuse=fuse, stragglers=s_tol, speeds=EST,
                real=REAL)
        out[f"seeded_{g}"] = dict(arrival=arrival, fuse=fuse,
                                  faults=("seed", fuse, SEEDED_KINDS))
    return out


def reference_outputs(module="test_torch_faults"):
    mod = importlib.import_module(module)
    return {name: run_case("repro", **kw) for name, kw in mod.cases().items()}


def reference_fixture(tmp_path_factory, module):
    d = tmp_path_factory.mktemp(module)
    code = f"""
        import sys
        import numpy as np
        sys.path.insert(0, {os.path.dirname(__file__)!r})
        from test_torch_faults import reference_outputs
        for name, arrays in reference_outputs({module!r}).items():
            np.savez("{d}/" + name + ".npz", **arrays)
        print("done")
    """
    assert "done" in run_with_devices(code, n_devices=N)
    return {f[:-4]: dict(np.load(os.path.join(d, f)))
            for f in os.listdir(d)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_fixture(tmp_path_factory, "test_torch_faults")


def port(name, segmented, module_cases=None):
    kw = dict((module_cases or cases())[name])
    return run_case("repro_torch", segmented=segmented, device="cpu", **kw)


def assert_matches(got, want):
    for k in want:
        assert got[k].tolist() == want[k].tolist(), (k, got[k], want[k])
    for k in ("eigvec", "residuals"):
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k


def actions(out):
    return [r.split(":")[3] for r in out["records"].tolist()]


def assert_same_bits(a, b):
    assert a["eigvec"].tobytes() == b["eigvec"].tobytes()
    assert a["residuals"].tobytes() == b["residuals"].tobytes()


@pytest.mark.parametrize("segmented", MODES)
@pytest.mark.parametrize("grid", GRID, ids=lambda g: f"{g[0]}{g[1]}")
@pytest.mark.parametrize("kind", list(KINDS))
def test_covered_fault_kind_matches_reference(reference, kind, grid,
                                              segmented):
    """Each covered kind at step 3: the port equals the reference engine
    under the same schedule, and both equal the clean run's bits with one
    executor entry and no recovery."""
    g = f"{grid[0]}{grid[1]}"
    got = port(f"{kind}_{g}", segmented)
    assert_matches(got, reference[f"{kind}_{g}"])
    clean = reference[("clean_decentral_" if kind == "scheduler_kill"
                       else "clean_") + g]
    assert_same_bits(got, clean)
    assert actions(got) == [KINDS[kind][1]]
    assert got["counts"].tolist() == [STEPS, 0, 1]


@pytest.mark.parametrize("segmented", MODES)
@pytest.mark.parametrize("grid", FULL_GRID, ids=lambda g: f"{g[0]}{g[1]}")
def test_result_drop_full_arrival_fuse_grid(reference, grid, segmented):
    g = f"{grid[0]}{grid[1]}"
    got = port(f"result_drop_{g}", segmented)
    assert_matches(got, reference[f"result_drop_{g}"])
    assert_same_bits(got, reference[f"clean_{g}"])
    assert_matches(port(f"clean_{g}", segmented), reference[f"clean_{g}"])


@pytest.mark.parametrize("segmented", MODES)
@pytest.mark.parametrize("grid", GRID, ids=lambda g: f"{g[0]}{g[1]}")
def test_uncovered_crash_demotes_replans_reexecutes(reference, grid,
                                                    segmented):
    """S = 0: the crash aborts before anything dispatches, worker 2 is
    demoted for the rest of the run, the step re-executes, and the bits
    equal the clean S = 0 run's."""
    g = f"{grid[0]}{grid[1]}"
    got = port(f"crash_s0_{g}", segmented)
    assert_matches(got, reference[f"crash_s0_{g}"])
    assert_same_bits(got, reference[f"clean_s0_{g}"])
    assert actions(got) == ["demoted"]
    assert got["counts"].tolist() == [STEPS, 1, 1]
    assert "2" not in got["rep_available"][-1]


@pytest.mark.parametrize("segmented", MODES)
@pytest.mark.parametrize("s_tol", [1, 0])
@pytest.mark.parametrize("grid", GRID, ids=lambda g: f"{g[0]}{g[1]}")
def test_dispatch_timeout_matches_reference(reference, grid, s_tol,
                                            segmented):
    """Worker 0's modeled duration passes the deadline: covered at S = 1
    (masked, detection latency = the timeout), uncovered at S = 0
    (demoted and re-executed). Bits equal the run without a deadline."""
    g = f"{grid[0]}{grid[1]}"
    got = port(f"timeout_s{s_tol}_{g}", segmented)
    assert_matches(got, reference[f"timeout_s{s_tol}_{g}"])
    assert_same_bits(got, reference[f"untimed_s{s_tol}_{g}"])
    recs = got["records"].tolist()
    if s_tol:
        assert recs and all(r.split(":")[2] == "0"
                            and r.endswith(":masked:1.0") for r in recs)
        assert got["counts"][1] == 0
    else:
        # An uncovered timeout aborts without a record (as the
        # reference's): the recovery demotes worker 0.
        assert got["counts"][1] >= 1
        assert "0" not in got["rep_available"][-1]


@pytest.mark.parametrize("segmented", MODES)
@pytest.mark.parametrize("grid", GRID, ids=lambda g: f"{g[0]}{g[1]}")
def test_seeded_multi_fault_schedule(reference, grid, segmented):
    g = f"{grid[0]}{grid[1]}"
    got = port(f"seeded_{g}", segmented)
    assert_matches(got, reference[f"seeded_{g}"])
    assert_same_bits(got, reference[f"clean_{g}"])
    assert len(got["records"]) == 3


def test_fault_injector_forms_and_config_knobs():
    """``faults=`` takes a ChaosPlan, a FaultSpec iterable or an injector
    (absolute indices); the knobs validate at construction; the simulate
    backend refuses faults."""
    from repro_torch.api import ElasticEngine, EngineConfig
    from repro_torch.api import MatVecPowerIteration
    from repro_torch.faults import ChaosPlan, FaultInjector, FaultSpec
    from repro_torch.runtime import RunnerConfig, make_exact_matrix

    spec = FaultSpec("result_drop", 3, worker=2)
    want = [r.tolist() for r in
            port("result_drop_barrier1", None).values()]
    for form in (ChaosPlan([spec]), [spec], FaultInjector(ChaosPlan([spec]))):
        eng = engine("repro_torch", device="cpu")
        res = eng.run(make_exact_matrix(DIM, 0), n_steps=STEPS, faults=form)
        assert [r.tolist() for r in summarize(res).values()] == want
    with pytest.raises(ValueError, match="dispatch_timeout"):
        RunnerConfig(dispatch_timeout=0.0)
    with pytest.raises(ValueError, match="dispatch_timeout"):
        EngineConfig(dispatch_timeout=-1.0)
    with pytest.raises(ValueError, match="max_fault_retries"):
        EngineConfig(max_fault_retries=-1)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        EngineConfig(checkpoint_every=5)
    sim = ElasticEngine(MatVecPowerIteration(), n_machines=N)
    with pytest.raises(ValueError, match="simulate"):
        sim.run(n_steps=2, faults=[spec])
