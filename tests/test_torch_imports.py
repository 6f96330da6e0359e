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
            "repro_torch.launch.serve"} <= set(mods)
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


def test_core_and_runtime_host_layers_import_without_torch():
    """The planners, the simulator, the runner's host-side classes and the
    model configs are pure NumPy, as in the reference: importing them pulls
    in no torch."""
    code = textwrap.dedent("""
        import sys
        import repro_torch.core, repro_torch.runtime, repro_torch.api
        import repro_torch.configs
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


@pytest.mark.parametrize("kwargs,item", [
    (dict(arrival="first"), "item 5"),
    (dict(fuse_steps=4), "item 6"),
    (dict(dispatch_timeout=1.0), "item 8"),
    (dict(verify_results="always"), "item 8"),
    (dict(checkpoint_dir="ckpt"), "item 9"),
])
def test_unported_knobs_raise_at_construction(kwargs, item):
    from repro_torch.api import ElasticEngine, EngineConfig, MatVec

    with pytest.raises(NotImplementedError, match=item):
        ElasticEngine(MatVec(), cfg=EngineConfig(**kwargs), backend="device",
                      n_machines=4, device="cpu")


def test_unported_entry_points_raise():
    from repro_torch.api import ElasticEngine, MatVecPowerIteration

    eng = ElasticEngine(MatVecPowerIteration(), backend="device",
                        n_machines=4, device="cpu")
    for call, item in ((lambda: eng.prepare(), "item 10"),
                       (lambda: eng.save_state("d"), "item 9"),
                       (lambda: eng.run(None, 1, kill_scheduler_at=0),
                        "item 7"),
                       (lambda: eng.run(None, 1, faults=[]), "item 8")):
        with pytest.raises(NotImplementedError, match=item):
            call()


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
