"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and its device entry points run on CUDA or raise — never drift to the CPU."""

import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from conftest import REPO, SRC  # noqa: E402


def _port_modules():
    root = os.path.join(SRC, "repro_torch")
    mods = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), SRC)
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_port_imports_no_jax_and_no_reference_package():
    mods = _port_modules()
    assert {"repro_torch.kernels.usec_segmented",
            "repro_torch.kernels.flash_attention",
            "repro_torch.models.transformer",
            "repro_torch.models.moe",
            "repro_torch.models.ssm",
            "repro_torch.models.rglru",
            "repro_torch.launch.serve",
            "repro_torch.faults",
            "repro_torch.faults.chaos",
            "repro_torch.faults.integrity",
            "repro_torch.serve",
            "repro_torch.serve.server",
            "repro_torch.launch.serve_cli",
            "repro_torch.runtime.checkpoint",
            "repro_torch.kernels.tile_checksum",
            "repro_torch.configs.usec_paper",
            "repro_torch.models.losses",
            "repro_torch.optim.adamw",
            "repro_torch.data.pipeline",
            "repro_torch.runtime.compression",
            "repro_torch.runtime.trainstep",
            "repro_torch.launch.train",
            "repro_torch.launch.mesh",
            "repro_torch.launch.sharding",
            "repro_torch.launch.dryrun",
            "repro_torch.launch.op_cost",
            "repro_torch.models.parallel"} <= set(mods)
    code = textwrap.dedent(f"""
        import importlib, sys
        for m in {mods!r}:
            importlib.import_module(m)
        bad = sorted(k for k in sys.modules
                     if k == "jax" or k.startswith("jax")
                     or k == "repro" or k.startswith("repro."))
        assert not bad, bad
        print(len({mods!r}))
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.strip()) == len(mods)


def _imported(path):
    """The top-level names of the modules a Python file imports."""
    import ast

    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_scripts_and_examples_import_no_jax_and_no_reference_package():
    """``chip_smoke.py``, ``train_dist_probe.py`` and ``examples_torch/``
    import neither JAX nor the JAX package (read from their import
    statements, nested ones included)."""
    scripts = [os.path.join(REPO, f) for f in ("chip_smoke.py",
                                               "train_dist_probe.py")]
    ex = os.path.join(REPO, "examples_torch")
    scripts += [os.path.join(ex, f) for f in sorted(os.listdir(ex))
                if f.endswith(".py")]
    assert len(scripts) == 7
    for path in scripts:
        bad = _imported(path) & {"jax", "jaxlib", "repro"}
        assert not bad, (path, bad)


def _reference_symbols():
    """{module: public names} of the JAX package, read from its sources
    (its ``__all__``, else its top-level public names)."""
    import ast

    out = {}
    root = os.path.join(SRC, "repro")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            mod = os.path.relpath(path, SRC)[:-3].replace(os.sep, ".")
            mod = mod[: -len(".__init__")] if mod.endswith(".__init__") \
                else mod
            tree = ast.parse(open(path).read())
            names, listed = [], None
            for node in tree.body:
                if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                    names.append(node.name)
                elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                    targets = (node.targets if isinstance(node, ast.Assign)
                               else [node.target])
                    for t in targets:
                        if isinstance(t, ast.Name):
                            if t.id == "__all__":
                                listed = [e.value for e in node.value.elts]
                            names.append(t.id)
            out[mod] = listed if listed is not None else [
                n for n in names if not n.startswith("_")]
    return out


def test_port_map_names_every_symbol_and_every_port_symbol_imports():
    """``docs/port_map.md``: every public symbol of the JAX package has a
    row, and every port symbol a row names imports (in a subprocess that
    then holds no JAX)."""
    import re

    rows = re.findall(r"^\| `(repro\.[\w.]+)` \| (.+?) \|",
                      open(os.path.join(REPO, "docs", "port_map.md")).read(),
                      re.M)
    mapped = {ref: port for ref, port in rows}
    want = {f"{m}.{n}" for m, names in _reference_symbols().items()
            for n in names}
    assert want <= set(mapped), sorted(want - set(mapped))[:20]
    ports = sorted({p.strip("`") for p in mapped.values()
                    if p.startswith("`repro_torch")})
    missing = [r for r, p in mapped.items() if not p.startswith("`")
               and not p.startswith("no counterpart, because ")]
    assert not missing, missing
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {ports!r}:
            mod, _, attr = name.rpartition(".")
            try:
                obj = getattr(importlib.import_module(mod), attr)
            except (ImportError, AttributeError):
                obj = importlib.import_module(name)
            assert obj is not None, name
        bad = sorted(k for k in sys.modules if k.split(".")[0] in
                     ("jax", "repro"))
        assert not bad, bad
        print(len({ports!r}))
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.strip()) == len(ports) > 300


def test_core_and_runtime_host_layers_import_without_torch():
    """The planners, the simulator, the runner's host-side classes, the
    fault schedule and the model configs are pure NumPy, as in the
    reference: importing them pulls in no torch."""
    code = textwrap.dedent("""
        import sys
        import repro_torch.core, repro_torch.runtime, repro_torch.api
        import repro_torch.configs, repro_torch.faults
        assert "torch" not in sys.modules, "torch imported eagerly"
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_device_engine_without_cuda_raises(monkeypatch):
    from repro_torch.api import ElasticEngine, MatVecPowerIteration
    from repro_torch.runtime import ElasticRunner, make_exact_matrix
    from repro_torch.core import cyclic_placement

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ElasticEngine(MatVecPowerIteration(), backend="device", n_machines=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ElasticRunner(make_exact_matrix(64), cyclic_placement(4, 4, 2))
    # An explicit host device is the only way onto the CPU.
    eng = ElasticEngine(MatVecPowerIteration(), backend="device",
                        n_machines=4, device="cpu")
    assert eng.device == torch.device("cpu")
    # The simulate backend needs no device at all.
    ElasticEngine(MatVecPowerIteration(), backend="simulate", n_machines=4)


def test_train_main_without_cuda_raises(monkeypatch):
    """The trainer runs on the card unless ``--device`` names another:
    without a GPU it raises before any step."""
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "stablelm-1.6b", "--reduced", "--steps", "1"])


@pytest.mark.parametrize("kwargs", [
    dict(checkpoint_dir="ckpt", checkpoint_every=2),
    dict(checkpoint_dir="ckpt", checkpoint_on_fault=True),
    dict(checkpoint_dir="ckpt"),
])
def test_checkpoint_knobs_construct(kwargs):
    from repro_torch.api import ElasticEngine, EngineConfig, MatVec

    cfg = EngineConfig(**kwargs)
    eng = ElasticEngine(MatVec(), cfg=cfg, backend="device", n_machines=4,
                        device="cpu")
    assert eng.cfg.checkpoint_dir == "ckpt"


def test_prepare_and_save_state_entry_points(tmp_path):
    """``prepare()`` stages the data and returns the runner; ``save_state``
    writes a checkpoint manifest that ``resume`` reads back."""
    from repro_torch.api import ElasticEngine, MatVecPowerIteration
    from repro_torch.runtime import make_exact_matrix

    eng = ElasticEngine(MatVecPowerIteration(), backend="device",
                        n_machines=4, device="cpu")
    runner = eng.prepare(make_exact_matrix(64))
    assert runner is eng.runner and runner.device == torch.device("cpu")
    path = eng.save_state(str(tmp_path))
    assert os.path.exists(os.path.join(path, "manifest.json"))
    assert eng.resume(str(tmp_path)) == (0, None)


def test_fault_abort_past_max_fault_retries_reraises():
    """The recovery loop re-executes a step at most ``max_fault_retries``
    times: a fault that keeps firing at the same step re-raises."""
    from repro_torch.api import ElasticEngine, EngineConfig
    from repro_torch.api import MatVecPowerIteration, Policy
    from repro_torch.faults import ChaosPlan, FaultAbort, FaultInjector
    from repro_torch.faults import FaultSpec
    from repro_torch.runtime import make_exact_matrix

    class Relentless(FaultInjector):
        """Each crash taken schedules the next worker's at the same step."""

        def take(self, step, kinds=None):
            out = super().take(step, kinds)
            for spec in out:
                if spec.kind == "worker_crash":
                    self.add(FaultSpec("worker_crash", step,
                                       worker=spec.worker + 1),
                             absolute=True)
            return out

    eng = ElasticEngine(
        MatVecPowerIteration(seed=0),
        Policy(placement="cyclic", replication=3, stragglers=0),
        EngineConfig(block_rows=16, max_fault_retries=1),
        backend="device", n_machines=4, device="cpu")
    inj = Relentless(ChaosPlan([FaultSpec("worker_crash", 1, worker=0)]))
    with pytest.raises(FaultAbort, match="worker_crash"):
        eng.run(make_exact_matrix(64), n_steps=3, faults=inj)
    assert [r.action for r in inj.log] == ["demoted", "demoted"]
    assert eng.runner.membership == (1, 2, 3)


@pytest.mark.parametrize("mode", ["pallas", "interpret"])
def test_reference_kernel_modes_rejected(mode):
    from repro_torch.api import EngineConfig
    from repro_torch.kernels import ops
    from repro_torch.runtime.elastic_runner import KERNEL_MODES

    # The torch-free config layer keeps its own copy of the route names.
    assert KERNEL_MODES == ops.MODES
    with pytest.raises(ValueError, match="cuda"):
        ops.usec_matvec(torch.ones(4, 4), torch.ones(4), mode=mode)
    with pytest.raises(ValueError):
        EngineConfig(segmented=mode)
