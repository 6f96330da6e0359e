"""The port's examples (``examples_torch/``) and its deprecated entry points.

Each example twin runs with ``--device cpu`` at a small size; the
quickstart prints what ``examples/quickstart.py`` prints, line for line.
``repro_torch.runtime.run_power_iteration`` (through
``ElasticEngine.from_runner``) equals the reference's legacy run of
``tests/test_api_engine.py::
test_engine_device_matvec_bit_exact_vs_legacy_run_power_iteration`` bit for
bit (the reference in a subprocess with 4 forced host devices), and the
engine path equals it too."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import REPO, SRC  # noqa: E402

EXAMPLES = os.path.join(REPO, "examples_torch")
_ENV = dict(os.environ, PYTHONPATH=SRC + os.pathsep
            + os.environ.get("PYTHONPATH", ""))

# The legacy cell of tests/test_api_engine.py, on either package.
_LEGACY = textwrap.dedent("""
    import json, warnings
    import numpy as np
    from {pkg}.core import cyclic_placement
    from {pkg}.core.elastic import scripted_trace
    from {pkg}.runtime import (ElasticRunner, RunnerConfig,
                               SyntheticSpeedClock, make_exact_matrix,
                               run_power_iteration)
    from {pkg}.api import (ElasticEngine, EngineConfig, MatVecPowerIteration,
                           Policy)
    dim = 4 * 96
    x = make_exact_matrix(dim, 0)
    script = {{0: ((2,), ()), 1: ((), (2,)), 2: ((0,), ()), 4: ((), (0,))}}
    clock = lambda: SyntheticSpeedClock([1000., 1300., 1800., 2400.],
                                        jitter_sigma=0.05, seed=0)
    picker = np.random.default_rng(1)
    bad = lambda i, avail: (int(picker.choice(avail)),)
    runner = ElasticRunner(x, cyclic_placement(4, 4, 3),
                           RunnerConfig(block_rows=16, stragglers=1,
                                        verify="exact"), clock=clock(){dev})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", DeprecationWarning)
        legacy = run_power_iteration(runner, 7,
                                     events=scripted_trace(4, script),
                                     straggler_sets=bad, seed=0)
    picker = np.random.default_rng(1)
    eng = ElasticEngine(MatVecPowerIteration(seed=0),
                        Policy(placement="cyclic", replication=3,
                               stragglers=1),
                        EngineConfig(block_rows=16, verify="exact"),
                        backend="device", n_machines=4, clock=clock(){dev})
    res = eng.run(x, n_steps=7, events=scripted_trace(4, script),
                  straggler_sets=bad)
    def record(r, waste):
        return {{"eigvec": np.asarray(r.eigvec, np.float32).view(np.uint32)
                           .tolist(),
                 "residuals": [float(v) for v in r.residuals],
                 "eigval": float(r.eigval), "waste": int(waste),
                 "available": [list(map(int, a.available))
                               for a in r.reports]}}
    print("LEGACY " + json.dumps({{
        "legacy": record(legacy, legacy.total_waste),
        "engine": record(res.result, res.total_waste),
        "warned": [str(w.message) for w in caught
                   if issubclass(w.category, DeprecationWarning)]}}))
""")


def _run(args, env=None, timeout=300):
    proc = subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, timeout=timeout, env=env or _ENV,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def _legacy(out):
    line = next(ln for ln in out.splitlines() if ln.startswith("LEGACY "))
    return json.loads(line[len("LEGACY "):])


@pytest.fixture(scope="module")
def reference_legacy():
    env = dict(_ENV, XLA_FLAGS="--xla_force_host_platform_device_count=4")
    return _legacy(_run(["-c", _LEGACY.format(pkg="repro", dev="")],
                        env=env))


def test_quickstart_prints_the_reference_examples_lines():
    want = _run([os.path.join(REPO, "examples", "quickstart.py")])
    got = _run([os.path.join(EXAMPLES, "quickstart.py"), "--device", "cpu"])
    assert got == want
    assert "c* = 0.142857" in got


@pytest.mark.parametrize("name,args", [
    ("power_iteration.py", ["--steps", "3"]),
    ("elastic_matmat.py", ["--steps", "3"]),
    ("straggler_serving.py", []),
    ("elastic_training.py", ["--steps", "2", "--seq-len", "32",
                             "--layers", "1", "--d-model", "64"]),
])
def test_example_runs_on_the_host(name, args, tmp_path):
    if name == "elastic_training.py":
        args = args + ["--ckpt-dir", str(tmp_path / "ckpt")]
    out = _run([os.path.join(EXAMPLES, name), "--device", "cpu"] + args,
               timeout=600)
    expect = {"power_iteration.py": "bit-exact",
              "elastic_matmat.py": "(exact)",
              "straggler_serving.py": "tok/s",
              "elastic_training.py": "done: 2 steps"}[name]
    assert expect in out, out[-2000:]


@pytest.mark.filterwarnings(
    "ignore:run_power_iteration is deprecated:DeprecationWarning")
def test_run_power_iteration_and_from_runner_equal_the_reference(
        reference_legacy):
    got = _legacy(_run(["-c", _LEGACY.format(pkg="repro_torch",
                                             dev=', device="cpu"')]))
    want = reference_legacy
    assert got["legacy"] == want["legacy"]
    assert got["engine"] == want["engine"]
    assert got["legacy"] == got["engine"]
    assert got["warned"] and "deprecated" in got["warned"][0]


@pytest.mark.filterwarnings(
    "ignore:run_power_iteration is deprecated:DeprecationWarning")
def test_from_runner_adopts_the_runner_in_process():
    from repro_torch.api import ElasticEngine, MatVecPowerIteration
    from repro_torch.core import cyclic_placement
    from repro_torch.runtime import (
        ElasticRunner,
        RunnerConfig,
        make_exact_matrix,
        run_power_iteration,
    )

    x = make_exact_matrix(4 * 32, 0)
    runner = ElasticRunner(x, cyclic_placement(4, 4, 2),
                           RunnerConfig(block_rows=16, verify="exact"),
                           device="cpu")
    wl = MatVecPowerIteration(seed=0)
    eng = ElasticEngine.from_runner(runner, wl)
    assert eng.runner is runner and runner.workload is wl
    assert eng.device == runner.device and eng.placement is runner.placement
    with pytest.warns(DeprecationWarning, match="deprecated"):
        res = run_power_iteration(runner, 2, seed=0)
    assert len(res.reports) == 2 and np.isfinite(res.eigval)
