"""The whole slice, end to end: the port's ``ElasticEngine`` against the JAX
package's, on the paper's §V application at a small size.

``examples/power_iteration.py``'s setting: N = 4 workers, a 768 x 768
integer-valued matrix, ``block_rows = 16``, its scripted churn trace, a
``SyntheticSpeedClock`` (so plans are a deterministic function of the
trace), cyclic and MAN placements at S in {0, 1} with one forced straggler
per step at S = 1, 6 steps, ``verify="exact"``. The reference engine runs
once, in one subprocess with 4 forced host devices, for the whole grid; the
port runs the same grid on the CPU in both executor modes (per-block and
segmented). Bitwise: the eigenvector, the residuals and every step's plan
``seg_*`` arrays. Equal: churn events, plans compiled, cache hits, waste and
the per-step report fields that do not depend on wall time.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from conftest import run_with_devices  # noqa: E402

from repro_torch.api import (  # noqa: E402
    ElasticEngine,
    EngineConfig,
    MatVecPowerIteration,
    Policy,
)
from repro_torch.core.elastic import scripted_trace  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    SyntheticSpeedClock,
    make_exact_matrix,
)

N, DIM, STEPS = 4, 768, 6
BASE_SPEEDS = [1000.0, 1300.0, 1700.0, 2200.0]
SCRIPT = {0: ((3,), ()), 1: ((1,), (3,)), 2: ((), (1,)), 4: ((2,), ()),
          5: ((), (2,))}
GRID = [("cyclic", 0), ("man", 0), ("cyclic", 1), ("man", 1)]
SEG_FIELDS = ("seg_tile", "seg_start", "seg_len", "seg_id", "n_valid")
REPORT_FIELDS = ("step", "available", "replanned", "plan_cache_hit",
                 "straggled", "waste", "jit_cache_size")


def run_cell(pkg, kind, s_tol, segmented=None, device=None):
    """One engine run of the grid with package ``pkg`` ("repro" for the
    reference, in the subprocess; "repro_torch" for the port, here)."""
    import importlib

    api = importlib.import_module(pkg + ".api")
    elastic = importlib.import_module(pkg + ".core.elastic")
    rt = importlib.import_module(pkg + ".runtime")
    rng = np.random.default_rng(1)

    def one_straggler(step, membership):
        return (int(rng.choice(membership)),) if len(membership) > 1 else ()

    kw = {} if device is None else {"device": device}
    eng = api.ElasticEngine(
        api.MatVecPowerIteration(seed=0),
        api.Policy(placement=kind, replication=2 + s_tol, stragglers=s_tol),
        api.EngineConfig(block_rows=16, verify="exact", segmented=segmented),
        backend="device", n_machines=N,
        clock=rt.SyntheticSpeedClock(BASE_SPEEDS, jitter_sigma=0.03, seed=0),
        **kw)
    x = rt.make_exact_matrix(DIM, 0)
    plans = []
    if pkg == "repro":
        # The reference: a completion observer sees each step's plan.
        runner = eng.prepare(x)
        runner.add_completion_callback(
            lambda reps: plans.append(runner.current_plan))
    else:
        # The port has no observers yet: wrap the runner's step.
        runner = eng._runner = eng._build_runner(x)
        step = runner.step

        def observed(*a, **k):
            out = step(*a, **k)
            plans.append(runner.current_plan)
            return out

        runner.step = observed
    res = eng.run(None, n_steps=STEPS,
                  events=elastic.scripted_trace(N, SCRIPT),
                  straggler_sets=one_straggler if s_tol else None)
    r = res.result
    out = {
        "eigvec": r.eigvec, "residuals": np.asarray(r.residuals),
        "eigval": np.float64(r.eigval),
        "counts": np.array([r.churn_events, r.plans_compiled, r.cache_hits,
                            r.total_waste, r.executor_cache_size]),
    }
    for f in SEG_FIELDS:
        out[f] = np.stack([getattr(p, f) for p in plans])
    for f in REPORT_FIELDS:
        out["rep_" + f] = np.asarray(
            [repr(getattr(rep, f)) for rep in r.reports])
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("engine_parity")
    code = f"""
        import sys
        import numpy as np
        sys.path.insert(0, {os.path.dirname(__file__)!r})
        from test_torch_engine import GRID, run_cell
        for kind, s in GRID:
            np.savez("{d}/" + kind + str(s) + ".npz",
                     **run_cell("repro", kind, s))
        print("done")
    """
    assert "done" in run_with_devices(code, n_devices=N)
    return {(kind, s): dict(np.load(os.path.join(d, f"{kind}{s}.npz")))
            for kind, s in GRID}


@pytest.mark.parametrize("segmented", [None, "auto"])
@pytest.mark.parametrize("kind,s_tol", GRID)
def test_engine_matches_reference(reference, kind, s_tol, segmented):
    want = reference[(kind, s_tol)]
    got = run_cell("repro_torch", kind, s_tol, segmented, device="cpu")
    assert got["eigvec"].dtype == np.float32
    assert got["eigvec"].tobytes() == want["eigvec"].tobytes()
    assert got["residuals"].tobytes() == want["residuals"].tobytes()
    assert got["eigval"] == want["eigval"]
    for f in SEG_FIELDS:
        assert got[f].tobytes() == want[f].tobytes(), f
    # churn events, plans compiled, cache hits, waste, executor cache size
    assert got["counts"].tolist() == want["counts"].tolist()
    assert got["counts"][-1] == 1
    for f in REPORT_FIELDS:
        assert got["rep_" + f].tolist() == want["rep_" + f].tolist(), f


def test_simulate_backend_bitwise_completion_times():
    from repro.api import ElasticEngine as RefEngine
    from repro.api import EngineConfig as RefConfig
    from repro.api import MatVec as RefMatVec
    from repro.api import Policy as RefPolicy
    from repro.core.elastic import scripted_trace as ref_trace
    from repro_torch.api import MatVec

    cfg = dict(n_draws=400, rows_per_tile=192, block_rows=16, seed=3,
               arrival="first")
    pol = dict(placement="man", replication=3, stragglers=1)
    a = RefEngine(RefMatVec(), RefPolicy(**pol), RefConfig(**cfg),
                  n_machines=N).run(n_steps=STEPS,
                                    events=ref_trace(N, SCRIPT))
    b = ElasticEngine(MatVec(), Policy(**pol), EngineConfig(**cfg),
                      n_machines=N).run(n_steps=STEPS,
                                        events=scripted_trace(N, SCRIPT))
    assert a.completion_times.tobytes() == b.completion_times.tobytes()
    assert np.isfinite(b.completion_times).all()
    assert (a.total_waste, a.churn_events, a.plans_compiled, a.cache_hits,
            a.stragglers) == (b.total_waste, b.churn_events,
                              b.plans_compiled, b.cache_hits, b.stragglers)


def test_device_engine_rejects_new_data_after_first_run():
    eng = ElasticEngine(
        MatVecPowerIteration(), Policy(placement="cyclic", replication=2),
        EngineConfig(block_rows=16, verify="exact"), backend="device",
        n_machines=N, device="cpu",
        clock=SyntheticSpeedClock(BASE_SPEEDS, seed=0))
    x = make_exact_matrix(128, 0)
    first = eng.run(x, n_steps=2).result
    assert first.executor_cache_size == 1 and len(first.reports) == 2
    assert eng.run(None, n_steps=1).result.executor_cache_size == 1
    with pytest.raises(ValueError, match="already staged"):
        eng.run(x, n_steps=1)
