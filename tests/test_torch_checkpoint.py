"""Checkpoint/restart in the port against the JAX package's
(``tests/test_checkpoint_serve.py``'s contracts): the checkpoint substrate
(round trip, the LATEST pointer, bf16 widened on disk, loud failures), the
engine's ``save_state``/``resume`` and ``checkpoint_*`` knobs, and the
on-disk format shared with the reference — a checkpoint written by either
package restores in the other.

The engine cases use the reference's restart-drill fleet: N = 4, cyclic
J = 3, S = 1, a 384 x 384 integer-valued matrix, ``block_rows = 16``,
``verify="exact"``, a synthetic clock with jitter 0.1 (so the EWMA, the plan
cache and the clock's RNG all carry state across the cut). The resumed run
is held to the reference's resumed run and to the uninterrupted run over
(fuse, cut) in {1, 4} x {3, 5} (cut 5 with fuse 4 lands mid-window). The
reference runs once, in one subprocess with 4 forced host devices.
Tolerance: bitwise everywhere.
"""

import importlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _hypothesis_compat import given, strategies as st  # noqa: E402
from conftest import run_with_devices  # noqa: E402

from repro_torch.runtime.checkpoint import (  # noqa: E402
    CheckpointCorruptError,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)

N, DIM, STEPS = 4, 4 * 96, 9
BASE = [1000.0, 1400.0, 1900.0, 2600.0]
DRILL = [(fuse, cut) for fuse in (1, 4) for cut in (3, 5)]


def engine(pkg, fuse=1, stragglers=1, jitter=0.1, **cfg):
    api = importlib.import_module(pkg + ".api")
    rt = importlib.import_module(pkg + ".runtime")
    dev = {"device": "cpu"} if pkg == "repro_torch" else {}
    return api.ElasticEngine(
        api.MatVecPowerIteration(seed=0),
        api.Policy(placement="cyclic", replication=3, stragglers=stragglers),
        api.EngineConfig(block_rows=16, verify="exact",
                         initial_speeds=tuple(BASE), fuse_steps=fuse, **cfg),
        backend="device", n_machines=N,
        clock=rt.SyntheticSpeedClock(BASE, jitter_sigma=jitter, seed=0),
        **dev)


def drill(pkg, fuse, cut, d):
    """Run ``cut`` steps, save_state, resume in a FRESH engine, finish."""
    rt = importlib.import_module(pkg + ".runtime")
    x = rt.make_exact_matrix(DIM, 0)
    e1 = engine(pkg, fuse)
    e1.run(x, n_steps=cut)
    e1.save_state(d)
    e2 = engine(pkg, fuse)
    step, w = e2.resume(d, data=x)
    assert step == cut, (step, cut)
    res = e2.run(n_steps=STEPS - cut, operand=w)
    return res.result.eigvec, np.asarray(res.result.residuals)


def periodic(pkg, fuse, d):
    """``checkpoint_every=2`` over 8 steps: the notes of the checkpoints."""
    rt = importlib.import_module(pkg + ".runtime")
    res = engine(pkg, fuse, checkpoint_dir=d, checkpoint_every=2).run(
        rt.make_exact_matrix(DIM, 0), n_steps=8)
    return [os.path.basename(p) for p in res.checkpoints]


def host_tree(seed):
    """The cross-package tree, as host arrays (bf16 as float32 values)."""
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((3, 4)),
        "nested": {"b": rng.integers(-10 ** 6, 10 ** 6, size=7,
                                     dtype=np.int32),
                   "c": rng.standard_normal(2).astype(np.float32),
                   "h": rng.standard_normal(5).astype(np.float32)},
        "seq": [np.arange(3, dtype=np.int32), np.ones(2)],
    }


def port_tree(seed):
    t = host_tree(seed)
    t["nested"]["h"] = torch.from_numpy(t["nested"]["h"]).to(torch.bfloat16)
    return t


REFERENCE = """
import json, os, sys
import numpy as np
import ml_dtypes
import jax.numpy as jnp
sys.path.insert(0, {tests!r})
from test_torch_checkpoint import (DRILL, drill, engine, host_tree,
                                   periodic, STEPS)
from repro.runtime import make_exact_matrix
from repro.runtime.checkpoint import (latest_checkpoint, restore_checkpoint,
                                      save_checkpoint)
D = {d!r}
out = {{}}

def ref_tree(seed):
    t = host_tree(seed)
    t["nested"]["h"] = jnp.asarray(t["nested"]["h"].astype(ml_dtypes.bfloat16))
    return t

# The port's checkpoints restore here.
step, got, extra = restore_checkpoint(os.path.join(D, "port_tree",
                                                   "step_000000007"),
                                      ref_tree(0))
want = host_tree(0)
out["port_tree"] = bool(
    step == 7 and extra == {{"by": "port"}}
    and np.asarray(got["w"]).tobytes() == want["w"].tobytes()
    and np.asarray(got["nested"]["b"]).tobytes()
    == want["nested"]["b"].tobytes()
    and np.asarray(got["nested"]["c"]).tobytes()
    == want["nested"]["c"].tobytes()
    and got["nested"]["h"].dtype == jnp.bfloat16
    and np.asarray(got["nested"]["h"], np.float32).tobytes()
    == want["nested"]["h"].astype(ml_dtypes.bfloat16).astype(
        np.float32).tobytes()
    and np.asarray(got["seq"][0]).tobytes() == want["seq"][0].tobytes())
x = make_exact_matrix({dim}, 0)
clean = engine("repro").run(x, n_steps=STEPS)
e = engine("repro")
step, w = e.resume(os.path.join(D, "port_engine"), data=x)
res = e.run(n_steps=STEPS - step, operand=w)
out["port_engine"] = bool(
    step == 5 and np.array_equal(res.result.eigvec, clean.result.eigvec)
    and res.result.residuals == clean.result.residuals[step:])

# The reference's checkpoints, for the port to restore.
save_checkpoint(os.path.join(D, "ref_tree"), 11, ref_tree(1),
                extra={{"by": "reference"}})
e = engine("repro")
e.run(x, n_steps=5)
e.save_state(os.path.join(D, "ref_engine"))
for fuse, cut in DRILL:
    v, r = drill("repro", fuse, cut, os.path.join(D, f"drill_{{fuse}}_{{cut}}"))
    np.savez(os.path.join(D, f"drill_{{fuse}}_{{cut}}.npz"), eigvec=v,
             residuals=r)
for fuse in (1, 4):
    out[f"periodic_{{fuse}}"] = periodic(
        "repro", fuse, os.path.join(D, f"periodic_{{fuse}}"))
clean = engine("repro").run(x, n_steps=STEPS)
np.savez(os.path.join(D, "clean.npz"), eigvec=clean.result.eigvec,
         residuals=np.asarray(clean.result.residuals))
with open(os.path.join(D, "out.json"), "w") as f:
    json.dump(out, f)
print("done")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The port writes its checkpoints, then one reference subprocess
    restores them and writes its own; returns (dir, the reference's
    verdicts and outputs)."""
    from repro_torch.runtime import make_exact_matrix

    d = str(tmp_path_factory.mktemp("ckpt"))
    save_checkpoint(os.path.join(d, "port_tree"), 7, port_tree(0),
                    extra={"by": "port"})
    e = engine("repro_torch")
    e.run(make_exact_matrix(DIM, 0), n_steps=5)
    e.save_state(os.path.join(d, "port_engine"))
    code = REFERENCE.format(tests=os.path.dirname(__file__), d=d, dim=DIM)
    assert "done" in run_with_devices(code, n_devices=N)
    with open(os.path.join(d, "out.json")) as f:
        return d, json.load(f)


# ---------------------------------------------------------------------- #
# The checkpoint substrate
# ---------------------------------------------------------------------- #
def test_checkpoint_roundtrip_bitwise_and_latest_pointer(tmp_path):
    d = str(tmp_path)
    tree = {
        "w": np.arange(12, dtype=np.float64).reshape(3, 4) / 7.0,
        "nested": {"b": np.array([1, 2, 3], dtype=np.int32)},
    }
    extra = {"note": "mid-run", "version": 3}
    p1 = save_checkpoint(d, 5, tree, extra)
    assert latest_checkpoint(d) == p1
    step, got, got_extra = restore_checkpoint(p1, tree)
    assert step == 5 and got_extra == extra
    assert got["w"].tobytes() == tree["w"].tobytes()
    assert got["nested"]["b"].tobytes() == tree["nested"]["b"].tobytes()
    # A later save moves LATEST; the old checkpoint stays restorable.
    p2 = save_checkpoint(d, 9, tree)
    assert latest_checkpoint(d) == p2 and p2 != p1
    assert restore_checkpoint(p1, tree)[0] == 5


def test_checkpoint_bf16_widens_and_restores_dtype(tmp_path):
    tree = {"p": torch.linspace(0, 1, 8, dtype=torch.bfloat16)}
    path = save_checkpoint(str(tmp_path), 0, tree)
    # On disk: widened float32 (npz cannot hold bf16)...
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["leaves"][0]["dtype"] == "bfloat16"
    assert manifest["leaves"][0]["key"] == "['p']"
    raw = np.load(os.path.join(path, manifest["leaves"][0]["file"]))["value"]
    assert raw.dtype == np.float32
    # ... restored: cast back to the prototype's bf16, value-identical.
    _, got, _ = restore_checkpoint(path, tree)
    assert got["p"].dtype == torch.bfloat16
    assert torch.equal(got["p"], tree["p"])


def test_checkpoint_shape_mismatch_and_missing_leaf_fail_loudly(tmp_path):
    tree = {"w": np.ones((2, 2))}
    path = save_checkpoint(str(tmp_path), 1, tree)
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(path, {"w": np.ones((3, 3))})
    with pytest.raises(KeyError, match="missing leaf"):
        restore_checkpoint(path, {"other": np.ones((2, 2))})
    assert latest_checkpoint(str(tmp_path / "nowhere")) is None
    # A bit-flipped leaf file is refused, naming the file.
    leaf = os.path.join(path, "leaf_00000.npz")
    with open(leaf, "r+b") as f:
        f.seek(-3, os.SEEK_END)
        f.write(b"\x00\x01\x02")
    with pytest.raises(CheckpointCorruptError, match="leaf_00000"):
        restore_checkpoint(path, tree)


_LEAF_DTYPES = ("float64", "float32", "bfloat16", "int32")


@given(
    outer=st.sampled_from(_LEAF_DTYPES),
    inner=st.sampled_from(_LEAF_DTYPES),
    as_tensor=st.booleans(),
    step=st.integers(min_value=0, max_value=10 ** 9),
    seed=st.integers(min_value=0, max_value=2 ** 16),
)
def test_checkpoint_roundtrip_property(outer, inner, as_tensor, step, seed):
    """Any nested tree of f64/f32/bf16/i32 leaves — host arrays or torch
    tensors (bf16 always a tensor) — round-trips bitwise, whatever step it
    was stamped with."""
    import shutil
    import tempfile

    rng = np.random.default_rng(seed)

    def leaf(dtype, shape):
        if dtype == "int32":
            a = rng.integers(-10 ** 6, 10 ** 6, size=shape, dtype=np.int32)
        else:
            a = rng.standard_normal(shape).astype(
                np.float32 if dtype == "bfloat16" else np.dtype(dtype))
        if dtype == "bfloat16":
            return torch.from_numpy(a).to(torch.bfloat16)
        return torch.from_numpy(a) if as_tensor else a

    tree = {"w": leaf(outer, (3, 4)),
            "nested": {"b": leaf(inner, (7,)),
                       "deep": {"c": leaf(outer, (2,))}}}
    d = tempfile.mkdtemp()
    try:
        path = save_checkpoint(d, step, tree, extra={"stamp": step})
        got_step, got, extra = restore_checkpoint(path, tree)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    assert got_step == step and extra == {"stamp": step}
    for want, have in ((tree["w"], got["w"]),
                       (tree["nested"]["b"], got["nested"]["b"]),
                       (tree["nested"]["deep"]["c"],
                        got["nested"]["deep"]["c"])):
        assert type(have) is type(want)
        if torch.is_tensor(want):
            assert have.dtype == want.dtype and torch.equal(have, want)
        else:
            assert have.dtype == want.dtype
            assert have.tobytes() == want.tobytes()


def test_midrun_checkpoint_resume_bitwise(tmp_path):
    """The restart drill on the port: run 9 steps; separately run 5,
    checkpoint the iterate, restore into a FRESH engine, run the remaining
    4 — final eigvec and the resumed steps' residuals bitwise-equal."""
    from repro_torch.runtime import make_exact_matrix

    x = make_exact_matrix(DIM, 0)
    ref = engine("repro_torch", jitter=0.0).run(x, n_steps=9)
    res1 = engine("repro_torch", jitter=0.0).run(x, n_steps=5)
    save_checkpoint(str(tmp_path), 5, {"w": res1.result.eigvec},
                    extra={"n_done": 5})
    step, tree, extra = restore_checkpoint(
        latest_checkpoint(str(tmp_path)), {"w": res1.result.eigvec})
    assert step == 5 and extra["n_done"] == 5
    res2 = engine("repro_torch", jitter=0.0).run(
        x, n_steps=9 - step, operand=tree["w"])
    assert np.array_equal(res2.result.eigvec, ref.result.eigvec)
    assert res2.result.residuals == ref.result.residuals[step:]


# ---------------------------------------------------------------------- #
# Across the two packages
# ---------------------------------------------------------------------- #
def test_port_checkpoints_restore_in_the_reference(reference):
    """A tree (f64, i32, f32, bf16 tensor, a list) and an engine snapshot
    written by the port restore in the JAX package, bitwise, and the
    reference's resumed run equals its uninterrupted one."""
    _, out = reference
    assert out["port_tree"] is True
    assert out["port_engine"] is True


def test_reference_checkpoints_restore_in_the_port(reference):
    from repro_torch.runtime import make_exact_matrix

    d, _ = reference
    path = latest_checkpoint(os.path.join(d, "ref_tree"))
    step, got, extra = restore_checkpoint(path, port_tree(1))
    want = host_tree(1)
    assert step == 11 and extra == {"by": "reference"}
    assert got["w"].tobytes() == want["w"].tobytes()
    assert got["nested"]["b"].tobytes() == want["nested"]["b"].tobytes()
    assert got["nested"]["c"].tobytes() == want["nested"]["c"].tobytes()
    assert got["nested"]["h"].dtype == torch.bfloat16
    assert torch.equal(got["nested"]["h"], torch.from_numpy(
        want["nested"]["h"]).to(torch.bfloat16))
    assert got["seq"][1].tobytes() == want["seq"][1].tobytes()
    # The reference's engine snapshot resumes the port's engine.
    clean = np.load(os.path.join(d, "clean.npz"))
    x = make_exact_matrix(DIM, 0)
    e = engine("repro_torch")
    step, w = e.resume(os.path.join(d, "ref_engine"), data=x)
    res = e.run(n_steps=STEPS - step, operand=w)
    assert step == 5
    assert res.result.eigvec.tobytes() == clean["eigvec"].tobytes()
    assert np.asarray(res.result.residuals).tobytes() == \
        clean["residuals"][step:].tobytes()


@pytest.mark.parametrize("fuse,cut", DRILL)
def test_resumed_run_equals_reference_resumed_run(reference, tmp_path, fuse,
                                                  cut):
    """save_state after ``cut`` steps, resume in a fresh engine, finish:
    the port's tail equals the reference's resumed tail and the
    uninterrupted run, bitwise (fused windows recompile from the restored
    state; cut 5 at fuse 4 re-tiles the windows)."""
    d, _ = reference
    want = np.load(os.path.join(d, f"drill_{fuse}_{cut}.npz"))
    clean = np.load(os.path.join(d, "clean.npz"))
    v, r = drill("repro_torch", fuse, cut, str(tmp_path))
    assert v.tobytes() == want["eigvec"].tobytes() == \
        clean["eigvec"].tobytes()
    assert r.tobytes() == want["residuals"].tobytes() == \
        clean["residuals"][cut:].tobytes()


@pytest.mark.parametrize("fuse", [1, 4])
def test_periodic_checkpoints_match_reference(reference, tmp_path, fuse):
    """``checkpoint_every=2``: the same snapshots at the same engine steps
    (fused runs at window boundaries), listed in ``EngineResult``."""
    _, out = reference
    got = periodic("repro_torch", fuse, str(tmp_path))
    assert got == out[f"periodic_{fuse}"] and got
    assert latest_checkpoint(str(tmp_path)).endswith(got[-1])


def test_checkpoint_on_fault_snapshots_before_the_retry(tmp_path):
    """An uncovered crash at S = 0 aborts the dispatch: with
    ``checkpoint_on_fault`` the engine snapshots the (valid) carry before
    re-executing, and resuming from that snapshot reproduces the tail."""
    from repro_torch.faults import ChaosPlan, FaultSpec
    from repro_torch.runtime import make_exact_matrix

    x = make_exact_matrix(DIM, 0)
    res = engine("repro_torch", stragglers=0, jitter=0.0,
                 checkpoint_dir=str(tmp_path), checkpoint_on_fault=True).run(
        x, n_steps=6, faults=ChaosPlan([FaultSpec("worker_crash", 3,
                                                  worker=2)]))
    assert res.recoveries == 1 and len(res.checkpoints) == 1
    with open(os.path.join(res.checkpoints[0], "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 3
    assert manifest["extra"]["engine"]["note"].startswith(
        "on-fault: worker_crash")
