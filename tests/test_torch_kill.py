"""The engine's scheduler kill (``ElasticEngine.run(kill_scheduler_at=i)``)
in the port against the JAX package's.

The kill is one ``scheduler_kill`` fault on the run's injector: it
tombstones the central Algorithm-1 master before step ``i`` plans. Under
``replan="decentral"`` the replicated local rule keeps the run going, and
the outputs stay bitwise-equal to the uninterrupted central run; under
``replan="central"`` the next plan raises ``SchedulerKilledError``.
``tests/test_decentral.py``'s drill (N = 4, cyclic J = 3, S = 1, its churn
script, a noiseless synthetic clock, one forced straggler per step) on the
768 x 768 integer-valued matrix, in both executor modes, stepwise and with
fused first-arrival windows. The reference runs once, in one subprocess with
4 forced host devices. Tolerance: bitwise.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from conftest import run_with_devices  # noqa: E402

from test_torch_fused import N, SCRIPT, run_churn  # noqa: E402

MODES = [None, "auto"]
CHURN_STEPS = sorted(SCRIPT)
KEYS = ("eigvec", "residuals", "eigval", "rep_available", "rep_straggled")
FIRST = dict(fuse_steps=4, arrival="first")


def reference_outputs():
    return {"central": run_churn("repro", 1, replan="central"),
            "central_first": run_churn("repro", replan="central", **FIRST),
            "decentral_kill3_first": run_churn(
                "repro", replan="decentral", kill_scheduler_at=3, **FIRST)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("kill_parity")
    code = f"""
        import sys
        import numpy as np
        sys.path.insert(0, {os.path.dirname(__file__)!r})
        from test_torch_kill import reference_outputs
        for name, arrays in reference_outputs().items():
            np.savez("{d}/" + name + ".npz", **arrays)
        print("done")
    """
    assert "done" in run_with_devices(code, n_devices=N)
    return {f[:-4]: dict(np.load(os.path.join(d, f)))
            for f in os.listdir(d)}


def assert_bitwise(got, want):
    for k in KEYS:
        assert got[k].tobytes() == want[k].tobytes(), k
    assert got["counts"][2] == 1        # executor_cache_size


@pytest.mark.parametrize("segmented", MODES)
def test_kill_at_every_churn_index_decentral_survives_bitwise(reference,
                                                              segmented):
    base = reference["central"]
    assert_bitwise(run_churn("repro_torch", 1, segmented, "cpu",
                             replan="decentral"), base)
    for kill in CHURN_STEPS:
        got = run_churn("repro_torch", 1, segmented, "cpu",
                        replan="decentral", kill_scheduler_at=kill)
        assert_bitwise(got, base)


def test_kill_records_a_fault_and_keeps_the_replica_master():
    from repro_torch.api import ElasticEngine, EngineConfig
    from repro_torch.api import MatVecPowerIteration, Policy
    from repro_torch.core.decentral import DecentralPlanner
    from repro_torch.core.elastic import scripted_trace
    from repro_torch.runtime import SyntheticSpeedClock, make_exact_matrix

    from test_torch_fused import BASE, DIM

    eng = ElasticEngine(
        MatVecPowerIteration(seed=0),
        Policy(placement="cyclic", replication=3, stragglers=1),
        EngineConfig(block_rows=16, verify="exact", replan="decentral",
                     initial_speeds=tuple(BASE)),
        backend="device", n_machines=N, device="cpu",
        clock=SyntheticSpeedClock(BASE, jitter_sigma=0.0, seed=0))
    res = eng.run(make_exact_matrix(DIM, 0), n_steps=4,
                  events=scripted_trace(N, SCRIPT), kill_scheduler_at=2)
    assert eng.runner.scheduler_killed
    assert isinstance(eng.runner.planning_master, DecentralPlanner)
    assert [(r.spec.kind, r.spec.step, r.action)
            for r in res.fault_records] == [("scheduler_kill", 2, "killed")]
    with pytest.raises(ValueError, match="outside"):
        eng.run(None, n_steps=2, kill_scheduler_at=2)
    sim = ElasticEngine(MatVecPowerIteration(), n_machines=N)
    with pytest.raises(ValueError, match="simulate"):
        sim.run(n_steps=2, kill_scheduler_at=0)


@pytest.mark.parametrize("segmented", MODES)
def test_kill_under_central_mode_fails_loudly(segmented):
    from repro_torch.core.decentral import SchedulerKilledError

    with pytest.raises(SchedulerKilledError, match="decentral"):
        run_churn("repro_torch", 1, segmented, "cpu", replan="central",
                  kill_scheduler_at=4)


@pytest.mark.parametrize("segmented", MODES)
def test_kill_composes_with_first_arrival_and_fused_windows(reference,
                                                            segmented):
    """arrival='first' x fuse_steps=4 x replan='decentral' x a mid-run
    kill: realized sets and outputs bitwise the uninterrupted central run
    under the same modes, and the reference's kill run."""
    base = reference["central_first"]
    for kill in (0, 3, 8):
        got = run_churn("repro_torch", segmented=segmented, device="cpu",
                        replan="decentral", kill_scheduler_at=kill, **FIRST)
        assert_bitwise(got, base)
        if kill == 3:
            want = reference["decentral_kill3_first"]
            for k in want:
                assert got[k].tobytes() == want[k].tobytes(), k
