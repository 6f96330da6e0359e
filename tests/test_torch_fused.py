"""Fused K-step windows (``fuse_steps = K > 1``) in the port against the JAX
package's.

A window runs K steps in one dispatch: per-step plans are stacked, include
weights come from a straggler bitmask on the device
(``device_include_weights``), the workload's ``fused_update`` carries the
iterate on the device, and in segmented mode on the card the whole window is
one CUDA graph replay. Here on the CPU both executor modes run the same loop
eagerly. The setting is ``tests/test_fused.py``'s (N = 4, cyclic J = 3,
S = 1, its 9-step churn script, a noiseless synthetic clock at the initial
speeds, one forced straggler per step) on the 768 x 768 integer-valued
matrix of ``tests/test_torch_engine.py``. The reference runs once, in one
subprocess with 4 forced host devices, for every case of this file.
Tolerance: bitwise (eigvec, residuals, results), equal (dispatch counts,
report fields, waste).

It mirrors ``tests/test_fused.py``'s cases, leaving out ``MapReduceRows``
(not ported yet): K in {1, 4} and fused first-arrival, the flush on a
plan-cache miss, dispatch counts and the tail window, the homogeneous
policy's full plan/waste parity, the c*-priced re-plan after a slowdown,
and ``MatMat``. It also holds the two on-device pieces to the reference's:
``device_include_weights`` against its ``jnp`` twin and the power
iteration's ``fused_update`` against the host ``quantize_unit``.
"""

import importlib
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from conftest import run_with_devices  # noqa: E402

N, DIM, STEPS = 4, 768, 9
BASE = [1000.0, 1400.0, 1900.0, 2600.0]
SCRIPT = {0: ((2,), ()), 1: ((), (2,)), 3: ((0,), ()), 5: ((), (0,)),
          6: ((3,), ()), 8: ((), (3,))}
MODES = [None, "auto"]
REPORT_FIELDS = ("step", "available", "replanned", "plan_cache_hit",
                 "straggled", "waste", "jit_cache_size",
                 "modeled_completion")


def _mods(pkg):
    return (importlib.import_module(pkg + ".api"),
            importlib.import_module(pkg + ".core.elastic"),
            importlib.import_module(pkg + ".runtime"))


def matmat_operand():
    rng = np.random.default_rng(5)
    return (np.round(rng.normal(size=(DIM, 8)) * 16) / 16).astype(np.float32)


def engine(pkg, fuse_steps, segmented=None, device=None, workload="pi",
           clock=None, homogeneous=False, **cfg_kw):
    api, _, rt = _mods(pkg)
    kw = dict(block_rows=16, verify="exact", fuse_steps=fuse_steps,
              initial_speeds=tuple(BASE), segmented=segmented)
    kw.update(cfg_kw)
    wl = (api.MatVecPowerIteration(seed=0) if workload == "pi"
          else api.MatMat(matmat_operand()))
    dev = {} if device is None else {"device": device}
    return api.ElasticEngine(
        wl, api.Policy(placement="cyclic", replication=3, stragglers=1,
                       homogeneous=homogeneous),
        api.EngineConfig(**kw), backend="device", n_machines=N,
        clock=(clock if clock is not None
               else rt.SyntheticSpeedClock(BASE, jitter_sigma=0.0, seed=0)),
        **dev)


def summarize(eng, res, workload="pi"):
    out = {"counts": np.array([res.n_steps, res.total_waste,
                               res.executor_cache_size,
                               eng.runner.device_dispatches])}
    if workload == "pi":
        out.update(eigvec=res.result.eigvec,
                   residuals=np.asarray(res.result.residuals),
                   eigval=np.float64(res.result.eigval))
    else:
        out["result"] = np.asarray(res.result)
    for f in REPORT_FIELDS:
        out["rep_" + f] = np.asarray(
            [repr(getattr(r, f)) for r in res.reports])
    return out


def run_churn(pkg, fuse_steps, segmented=None, device=None, workload="pi",
              inject=True, steps=STEPS, kill_scheduler_at=None, **cfg_kw):
    """The churn script with one forced straggler per step (or derived sets
    under first-arrival when ``inject`` is False)."""
    _, elastic, rt = _mods(pkg)
    pick = np.random.default_rng(1)
    bad = (lambda i, avail: (int(pick.choice(avail)),)) if inject else None
    eng = engine(pkg, fuse_steps, segmented, device, workload, **cfg_kw)
    x = rt.make_exact_matrix(DIM, 0)
    res = eng.run(x, n_steps=steps, events=elastic.scripted_trace(N, SCRIPT),
                  straggler_sets=bad, kill_scheduler_at=kill_scheduler_at)
    return summarize(eng, res, workload)


def run_static(pkg, fuse_steps, steps, segmented=None, device=None):
    _, _, rt = _mods(pkg)
    eng = engine(pkg, fuse_steps, segmented, device)
    res = eng.run(rt.make_exact_matrix(DIM, 0), n_steps=steps)
    return summarize(eng, res)


class SlowdownClock:
    """Worker 3 collapses to 1/8 speed after ``slow_after`` duration
    queries (``tests/test_fused.py``'s clock)."""

    def __init__(self, slow_after):
        self.slow_after = slow_after
        self.calls = 0

    def durations(self, row_loads, available, wall):
        s = np.asarray(BASE).copy()
        if self.calls >= self.slow_after:
            s[3] /= 8.0
        self.calls += 1
        return {n: float(row_loads[n]) / s[n]
                for n in available if row_loads[n] > 0}


def run_slowdown(pkg, segmented=None, device=None):
    _, _, rt = _mods(pkg)
    eng = engine(pkg, 4, segmented, device, clock=SlowdownClock(8))
    res = eng.run(rt.make_exact_matrix(DIM, 0), n_steps=32)
    out = summarize(eng, res)
    out["replans"] = np.asarray([r.step for r in res.reports
                                 if r.replanned and not r.plan_cache_hit])
    out["loads"] = eng.runner.current_plan.loads()
    return out


CASES = {
    "pi_k1": dict(fuse_steps=1),
    "pi_k4": dict(fuse_steps=4),
    "pi_k4_first": dict(fuse_steps=4, arrival="first", inject=False),
    "pi_k1_first": dict(fuse_steps=1, arrival="first", inject=False),
    "flush_k1": dict(fuse_steps=1, precompile_neighbors=False),
    "flush_k4": dict(fuse_steps=4, precompile_neighbors=False),
    "homog_k1": dict(fuse_steps=1, homogeneous=True),
    "homog_k4": dict(fuse_steps=4, homogeneous=True),
    "matmat_k1": dict(fuse_steps=1, workload="matmat"),
    "matmat_k4": dict(fuse_steps=4, workload="matmat"),
}


def reference_outputs():
    out = {name: run_churn("repro", **kw) for name, kw in CASES.items()}
    out["slowdown"] = run_slowdown("repro")
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("fused_parity")
    code = f"""
        import sys
        import numpy as np
        sys.path.insert(0, {os.path.dirname(__file__)!r})
        from test_torch_fused import reference_outputs
        for name, arrays in reference_outputs().items():
            np.savez("{d}/" + name + ".npz", **arrays)
        print("done")
    """
    assert "done" in run_with_devices(code, n_devices=N)
    return {f[:-4]: dict(np.load(os.path.join(d, f)))
            for f in os.listdir(d)}


def assert_equal(got, want, keys=None):
    for k in keys or want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), (k, got[k], want[k])


def assert_same_outputs(a, b):
    """Outputs and the step sequence (memberships, realized stragglers)
    bitwise/equal between two runs of the port."""
    keys = [k for k in ("eigvec", "residuals", "eigval", "result",
                        "rep_available", "rep_straggled") if k in a]
    assert_equal(a, b, keys)


@pytest.mark.parametrize("segmented", MODES)
@pytest.mark.parametrize("case", ["pi_k1", "pi_k4", "pi_k1_first",
                                  "pi_k4_first"])
def test_fused_power_iteration_matches_reference(reference, case,
                                                 segmented):
    kw = dict(CASES[case])
    got = run_churn("repro_torch", segmented=segmented, device="cpu", **kw)
    assert_equal(got, reference[case])
    assert got["counts"][2] == 1          # executor_cache_size
    if kw["fuse_steps"] > 1:
        # Windows span churn once plans are cached: 4 dispatches, 9 steps.
        assert got["counts"][3] == 4
        twin = reference[case.replace("k4", "k1")]
        assert_same_outputs(got, twin)


@pytest.mark.parametrize("segmented", MODES)
def test_fused_flush_on_plan_cache_miss_stays_bitwise(reference, segmented):
    """With the speculative precompiler off every churn event is a cache
    miss: the assembler flushes early (more dispatches than ceil(9/4)) and
    the outputs still equal stepwise."""
    got = run_churn("repro_torch", 4, segmented, "cpu",
                    precompile_neighbors=False)
    assert_equal(got, reference["flush_k4"])
    assert_same_outputs(got, reference["flush_k1"])
    assert got["counts"][3] > math.ceil(STEPS / 4)
    assert got["counts"][0] == STEPS and got["counts"][2] == 1


@pytest.mark.parametrize("segmented", MODES)
@pytest.mark.parametrize("steps,k", [(8, 4), (10, 4), (9, 7), (3, 8)])
def test_fused_dispatch_count_and_tail_window(steps, k, segmented):
    """Static membership: ceil(steps / K) dispatches, a ragged tail window
    included, bitwise the stepwise run."""
    got = run_static("repro_torch", k, steps, segmented, "cpu")
    assert got["counts"][3] == math.ceil(steps / k)
    assert got["counts"][0] == steps and got["counts"][2] == 1
    base = run_static("repro_torch", 1, steps, segmented, "cpu")
    assert_equal(got, base, ["eigvec", "residuals"])


@pytest.mark.parametrize("segmented", MODES)
def test_fused_homogeneous_policy_full_plan_and_waste_parity(reference,
                                                             segmented):
    got = run_churn("repro_torch", 4, segmented, "cpu", homogeneous=True)
    assert_equal(got, reference["homog_k4"])
    base = run_churn("repro_torch", 1, segmented, "cpu", homogeneous=True)
    assert_equal(base, reference["homog_k1"])
    assert_same_outputs(got, base)
    assert_equal(got, base, ["rep_waste", "rep_replanned"])
    assert got["counts"][1] == base["counts"][1]      # total waste


@pytest.mark.parametrize("segmented", MODES)
def test_fused_window_slowdown_triggers_cstar_priced_replan(reference,
                                                            segmented):
    got = run_slowdown("repro_torch", segmented, "cpu")
    assert_equal(got, reference["slowdown"])
    replans = got["replans"].tolist()
    assert replans[0] == 1 and len(replans) >= 2 and replans[1] > 8
    loads = got["loads"]
    assert loads[3] < loads[:3].max() / 2
    assert got["counts"][2] == 1


@pytest.mark.parametrize("segmented", MODES)
def test_fused_matmat_matches_reference(reference, segmented):
    got = run_churn("repro_torch", 4, segmented, "cpu", workload="matmat")
    assert_equal(got, reference["matmat_k4"])
    assert_same_outputs(got, reference["matmat_k1"])
    _, _, rt = _mods("repro_torch")
    x = rt.make_exact_matrix(DIM, 0).astype(np.float64)
    assert np.array_equal(got["result"],
                          x @ matmat_operand().astype(np.float64))


# ---------------------------------------------------------------------- #
# The on-device pieces against the reference's
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("width", [1, 2, 3])
def test_device_include_weights_matches_reference(width):
    import jax.numpy as jnp

    from repro.runtime.executor import device_include_weights as ref_diw
    from repro_torch.runtime.executor import device_include_weights

    rng = np.random.default_rng(width)
    n, b = 6, 40
    prio = np.stack([rng.permutation(n)[:width] for _ in range(n * b)])
    prio = prio.reshape(n, b, width).astype(np.int32)
    pad = rng.random((n, b)) < 0.3
    prio[pad] = -1
    valid = ~pad
    for trial in range(8):
        bad = rng.random(n) < 0.3
        want = np.asarray(ref_diw(jnp.asarray(prio), jnp.asarray(valid),
                                  jnp.asarray(bad)))
        got = device_include_weights(
            torch.as_tensor(prio), torch.as_tensor(valid.astype(np.float32)),
            torch.as_tensor(bad)).numpy()
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes(), trial
        assert not got[pad].any()


@pytest.mark.parametrize("stragglers", [(), (0,), (2,)])
def test_device_include_weights_matches_refresh_include(stragglers):
    """On a compiled plan the on-device weights are the host's
    ``refresh_include`` for the same straggler set."""
    from repro_torch.core import USECScheduler, cyclic_placement
    from repro_torch.runtime.executor import (
        block_plan,
        device_include_weights,
        device_plan,
        refresh_include,
        stage_matrix,
    )
    from repro_torch.runtime.elastic_runner import make_exact_matrix

    p = cyclic_placement(N, N, 3)
    sm = stage_matrix(make_exact_matrix(DIM, 0), p, DIM // N)
    sched = USECScheduler(p, DIM // N, np.asarray(BASE), stragglers=1,
                          row_align=16)
    plan = sched.plan_step(tuple(range(N))).plan
    bp = block_plan(plan, sm.slot_of, 16)
    dp = device_plan(bp, "cpu")
    bad = np.zeros(N, dtype=bool)
    bad[list(stragglers)] = True
    got = device_include_weights(dp.prio, dp.valid, torch.as_tensor(bad))
    assert got.numpy().tobytes() == \
        refresh_include(bp, plan, stragglers).tobytes()


def _update_inputs():
    rng = np.random.default_rng(3)
    vs = [rng.normal(size=n).astype(np.float32) * s
          for n, s in ((768, 1.0), (1000, 1e3), (6000, 1e-3), (7, 5.0))]
    # Every |u| below half a grid step: quantization leaves all zeros, and
    # the argmax fallback must pick the largest entry.
    flat = np.ones(400_000, dtype=np.float32)
    flat[12_345] = 1.1
    return vs + [flat]


@pytest.mark.parametrize("bits", [8, None])
def test_fused_update_bitwise_with_host_quantize_unit(bits):
    import jax.numpy as jnp

    from repro.api.workload import MatVecPowerIteration as RefPI
    from repro.runtime.elastic_runner import quantize_unit, unit_vector
    from repro_torch.api.workload import MatVecPowerIteration
    from repro_torch.runtime.elastic_runner import _tree_sumsq

    upd = MatVecPowerIteration(quantize_bits=bits).fused_update()
    ref_upd = RefPI(quantize_bits=bits).fused_update()
    for v in _update_inputs():
        got = upd(torch.as_tensor(v), None).numpy()
        want = quantize_unit(v, bits) if bits else unit_vector(v)
        assert got.dtype == np.float32
        assert got.tobytes() == want.tobytes()
        assert got.tobytes() == np.asarray(
            ref_upd(jnp.asarray(v), None)).tobytes()
        assert _tree_sumsq(torch.as_tensor(v), torch).numpy().tobytes() \
            == np.asarray(_tree_sumsq(v, np)).tobytes()
    if bits:
        got = upd(torch.as_tensor(_update_inputs()[-1]), None).numpy()
        assert np.flatnonzero(got).tolist() == [12_345]


def test_workload_fused_update_opt_out():
    """The identity update is the default only while ``consume`` is not
    overridden; a power iteration subclass with its own consume falls back
    to stepwise (no device twin), as in the reference."""
    from repro_torch.api.workload import MatMat, MatVecPowerIteration

    w = torch.ones(3)
    assert MatMat().fused_update()(torch.zeros(3), w) is w

    class Custom(MatVecPowerIteration):
        def consume(self, result, operand):
            return operand

    assert Custom().fused_update() is None
