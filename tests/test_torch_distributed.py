"""Training across worker processes: the port's usec step and trainer over
``torch.distributed`` (gloo ranks on the CPU) against its one-process step
and against the JAX package's ``shard_map`` step.

The ranks are spawned processes that meet in a file store under the test's
temporary directory (no fixed port), one thread each, so every process
computes each worker's gradient with the same float operations; the
one-process comparisons run with one thread too. Cells: reduced
stablelm-1.6b (dense), deepseek-moe-16b (MoE) and recurrentgemma-2b
(recurrent) in fp32, N = 4 workers, cyclic J = 2 over 8 tiles of one
32-token sample, S = 1, worker 1 dropped; the dense cell also with int8
compression over two chained steps and with ``static_trips``.

Tolerances: the fp32 master combine sums the same four worker totals in
another order, so a loss, a gradient norm or an updated leaf is within
1e-6 of its largest value. The compressed sum is exact (int8 values summed
in the wire dtype), so the updated parameters and moments, each worker's
error feedback and the new scales are bitwise equal. Against the reference,
1e-4 of the largest value (the same fp32 ops in another order through a
whole model), and for compressed steps the quantizer's rounding-tie rule of
``tests/test_torch_train.py``. The trainers' printed losses (4 decimals)
agree within one unit of the last digit.
"""

import contextlib
import dataclasses
import datetime
import io
import functools
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import REPO, SRC  # noqa: E402

from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (  # noqa: E402
    compile_plan,
    cyclic_placement,
    solve_assignment,
)
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    coordinates,
    data_group,
    make_production_mesh,
    make_worker_mesh,
    model_group,
    workers_of,
)
from repro_torch.models import build_model, params_from_reference  # noqa: E402
from repro_torch.models.transformer import tree_leaves  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import compression  # noqa: E402
from repro_torch.runtime.executor import block_plan  # noqa: E402
from repro_torch.runtime.trainstep import make_usec_train_step  # noqa: E402

N, G, J, SEQ, LR = 4, 8, 2, 32, 1e-3
ARCHS = {"dense": "stablelm-1.6b", "moe": "deepseek-moe-16b",
         "recurrent": "recurrentgemma-2b"}
DROP = (1,)
# The compressed chain: (dropped, data step) per step.
COMP_STEPS = (((1,), 0), ((), 1))
TRAIN_ARGS = ["--arch", "stablelm-1.6b", "--reduced", "--workers", "4",
              "--seq-len", "32", "--tile-samples", "1",
              "--straggler-tolerance", "1", "--drop-stragglers", "1",
              "--log-every", "1", "--device", "cpu"]
# Worker counts the wire test sums at: float16 up to 16, int32 above.
WIRE_WORKERS = (4, 8, 16, 20, 64, 256)
TIMEOUT = datetime.timedelta(seconds=120)


def _rel(got, want) -> float:
    got = np.asarray(torch.as_tensor(got).double())
    want = np.asarray(torch.as_tensor(want).double())
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else float(
        np.abs(got).max())


def _fp32(arch):
    return dataclasses.replace(get_config(arch).reduced(),
                               param_dtype="float32",
                               grad_accum_dtype="float32")


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """The reference's init of the reduced fp32 arch, as numpy."""
    import jax

    import repro.configs as rc
    from repro.models import build_model as ref_build_model

    cfg = dataclasses.replace(rc.get_config(arch).reduced(),
                              param_dtype="float32")
    return jax.tree.map(np.asarray,
                        ref_build_model(cfg).init(jax.random.PRNGKey(0)))


def _cell(arch):
    cfg = _fp32(arch)
    p = cyclic_placement(N, G, J)
    pipe = TokenPipeline(cfg, p, seq_len=SEQ, tile_samples=1, seed=0)
    plan = compile_plan(p, solve_assignment(p, np.ones(N), stragglers=1),
                        rows_per_tile=1, stragglers=1)
    return cfg, pipe, plan, int(plan.n_valid.max()) + 1


def _args(pipe, plan, b_max, bad, step=0):
    sb = pipe.staged_for_step(step)
    bp = block_plan(plan, sb.slot_of, 1, stragglers=bad, b_max=b_max)
    return (sb.arrays, bp.blk_slot, bp.blk_include, bp.n_blocks[:, None],
            torch.tensor(LR))


def _pack(m, params, opt, comp=None):
    out = {"loss": m["loss"], "gnorm": m["grad_norm"],
           "leaves": tree_leaves(params) + tree_leaves(opt["m"])}
    if comp is not None:
        out["ef"] = tree_leaves(comp["ef"])
        out["scale"] = tree_leaves(comp["scale"])
    return out


def run_cells(ref_params, group=None):
    """Every cell's step(s) on this process: all N workers without a
    group, this rank's workers with one."""
    out = {}
    world = 1 if group is None else torch.distributed.get_world_size(group)
    for kind, arch in ARCHS.items():
        cfg, pipe, plan, b_max = _cell(arch)
        bundle = build_model(cfg, device="cpu")
        params = params_from_reference(ref_params[arch], cfg, "cpu")
        step = make_usec_train_step(bundle, pipe.t_stage, b_max, group=group)
        new_p, new_o, _, m = step(params, adamw.init(params), None,
                                  *_args(pipe, plan, b_max, DROP))
        out[kind] = _pack(m, new_p, new_o)
        if kind != "dense":
            continue
        static = make_usec_train_step(bundle, pipe.t_stage, b_max,
                                      group=group, static_trips=b_max)
        new_p, new_o, _, m = static(params, adamw.init(params), None,
                                    *_args(pipe, plan, b_max, DROP))
        out["static"] = _pack(m, new_p, new_o)
        comp_step = make_usec_train_step(bundle, pipe.t_stage, b_max,
                                         compress_grads=True, group=group)
        opt, comp = adamw.init(params), compression.init_state(
            params, N // world)
        for s, (bad, data) in enumerate(COMP_STEPS):
            params, opt, comp, m = comp_step(
                params, opt, comp, *_args(pipe, plan, b_max, bad, data))
            out[f"comp{s}"] = _pack(m, params, opt, comp)
        out["stats"] = {"fp32": dict(step.stats),
                        "compressed": dict(comp_step.stats)}
    return out


def wire_sums(group):
    """For each of :data:`WIRE_WORKERS`: every worker's gradient is +127
    (then -127) quanta at a scale of 1, this rank's workers added to one
    :class:`CompressedSum` over ``group``; (N, reduced sums)."""
    world = torch.distributed.get_world_size(group)
    out = []
    for n in WIRE_WORKERS:
        for sign in (1.0, -1.0):
            like = {"w": torch.zeros(3)}
            state = compression.init_state(like, n // world)
            state["scale"]["w"] = torch.tensor(1.0)
            acc = compression.CompressedSum(state, n, group)
            g = {"w": torch.tensor([127.0, 300.0, 126.6]) * sign}
            for i in range(n // world):
                acc.add(i, g)
            red, _ = acc.result()
            out.append((n, sign, red["w"].tolist()))
    return out


def _init_ranks(rank, world, store):
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=TIMEOUT)


def _steps_job(rank, world, store, out_dir, ref_params):
    """One rank: the mesh's facts, every cell, and (4 ranks) the wire
    sums; saved to ``rank{rank}.pt``."""
    _init_ranks(rank, world, store)
    try:
        mesh = make_worker_mesh(N)
        group = mesh.get_group()
        res = run_cells(ref_params, group)
        res["mesh"] = {"names": mesh.mesh_dim_names, "size": mesh.size(),
                       "workers": list(workers_of(rank, world, N))}
        try:
            make_worker_mesh(5)
        except ValueError as e:
            res["mesh"]["uneven"] = f"{type(e).__name__}: {e}"
        two = make_worker_mesh(N, 2)
        res["mesh"]["model"] = {
            "names": two.mesh_dim_names, "shape": tuple(two.shape),
            "coords": coordinates(two),
            "data_ranks": torch.distributed.get_process_group_ranks(
                data_group(two)),
            "model_ranks": torch.distributed.get_process_group_ranks(
                model_group(two))}
        if world == 4:
            res["wire"] = wire_sums(group)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _mismatch_job(rank, world, store, out_dir):
    """The trainer on every rank, rank 1 with another plan: both raise."""
    _init_ranks(rank, world, store)
    try:
        if rank == 1:
            from repro_torch.runtime import executor

            real = executor.block_plan

            def other(*args, **kwargs):
                bp = real(*args, **kwargs)
                bp.blk_include[0, 0] = 1.0 - bp.blk_include[0, 0]
                return bp

            executor.block_plan = other
        try:
            port_train.main(TRAIN_ARGS + ["--steps", "2"])
            msg = "no error"
        except RuntimeError as e:
            msg = str(e)
        with open(os.path.join(out_dir, f"mismatch{rank}.txt"), "w") as fh:
            fh.write(msg)
    finally:
        torch.distributed.destroy_process_group()


def _spawn(job, world, tmp, *args):
    store = os.path.join(tmp, f"store{world}_{job.__name__}")
    torch.multiprocessing.start_processes(
        job, args=(world, store, tmp) + args, nprocs=world,
        start_method="spawn")


def _run_ranks(world, tmp, ref_params):
    os.makedirs(tmp)
    _spawn(_steps_job, world, tmp, ref_params)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------- #
# The reference's shard_map steps and its trainer (one subprocess, 4 host
# devices); the trainer resumes the port's 4-rank checkpoint.
# ---------------------------------------------------------------------- #
_REFERENCE = r"""
import dataclasses, json, os
import numpy as np, jax, jax.numpy as jnp
import repro.configs as rc
from repro.core import cyclic_placement, solve_assignment, compile_plan
from repro.data import TokenPipeline
from repro.models import build_model
from repro.optim import adamw
from repro.runtime import compression
from repro.runtime.executor import block_plan
from repro.runtime.trainstep import make_usec_train_step
from repro.launch.mesh import make_worker_mesh
from repro.jax_compat import set_mesh

OUT = {out!r}
N, G, J, SEQ, LR = {n}, {g}, {j}, {seq}, {lr}
ARCHS, DROP, COMP_STEPS = {archs!r}, {drop!r}, {comp_steps!r}
flat = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]
copy = lambda t: jax.tree.map(jnp.array, t)
mesh = make_worker_mesh(N, 1)


def save(name, m, p, o, extra=()):
    np.savez(os.path.join(OUT, name + ".npz"), loss=np.asarray(m["loss"]),
             gnorm=np.asarray(m["grad_norm"]),
             *(flat(p) + flat(o["m"]) + list(extra)))


with set_mesh(mesh):
    for kind, arch in ARCHS.items():
        cfg = dataclasses.replace(rc.get_config(arch).reduced(),
                                  param_dtype="float32",
                                  grad_accum_dtype="float32")
        bundle = build_model(cfg)
        params = bundle.init(jax.random.PRNGKey(0))
        p = cyclic_placement(N, G, J)
        pipe = TokenPipeline(cfg, p, seq_len=SEQ, tile_samples=1, seed=0)
        plan = compile_plan(p, solve_assignment(p, np.ones(N), stragglers=1),
                            rows_per_tile=1, stragglers=1)
        b_max = int(plan.n_valid.max()) + 1

        def args(bad, s):
            sb = pipe.staged_for_step(s)
            bp = block_plan(plan, sb.slot_of, 1, stragglers=tuple(bad),
                            b_max=b_max)
            return ({{k: jnp.asarray(v) for k, v in sb.arrays.items()}},
                    jnp.asarray(bp.blk_slot), jnp.asarray(bp.blk_include),
                    jnp.asarray(bp.n_blocks)[:, None], jnp.float32(LR))

        cells = [(kind, {{}})]
        if kind == "dense":
            cells.append(("static", {{"static_trips": b_max}}))
        for name, kw in cells:
            step = make_usec_train_step(bundle, mesh, pipe.t_stage, b_max, **kw)
            new_p, new_o, _, m = step(copy(params), adamw.init(params), None,
                                      *args(DROP, 0))
            save(name, m, new_p, new_o)
        if kind != "dense":
            continue
        step = make_usec_train_step(bundle, mesh, pipe.t_stage, b_max,
                                    compress_grads=True)
        pr, op = copy(params), adamw.init(params)
        cs = compression.init_state(params)
        for s, (bad, data) in enumerate(COMP_STEPS):
            pr, op, cs, m = step(pr, op, cs, *args(bad, data))
            save(f"comp{{s}}", m, pr, op, flat(cs["ef"]) + flat(cs["scale"]))

# The reference trainer resumes the port's checkpoint (fp32 configs).
from repro.launch.train import main
real = rc.get_config
rc.get_config = lambda name: dataclasses.replace(real(name), param_dtype="float32")
loss = main({train_args!r})
with open(os.path.join(OUT, "res.json"), "w") as fh:
    json.dump({{"resumed4": loss}}, fh)
print("done")
"""

# Runs ``repro_torch.launch.train.main`` with fp32 configs (the reference
# trainer's test setting), under torch.distributed.run or alone.
_FP32_TRAINER = """
import dataclasses, sys
from repro_torch import configs
real = configs.get_config
configs.get_config = lambda name: dataclasses.replace(real(name),
                                                     param_dtype="float32")
from repro_torch.launch.train import main
main(sys.argv[1:])
"""


def _start(cmd, env=None) -> subprocess.Popen:
    env = dict(env or os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=REPO)


def _finish(proc) -> str:
    out, err = proc.communicate(timeout=560)
    assert proc.returncode == 0, out[-3000:] + err[-3000:]
    return out


def _start_trainer(tmp, ranks, *extra) -> subprocess.Popen:
    """The fp32 trainer on ``ranks`` processes under ``python -m
    torch.distributed.run``."""
    script = os.path.join(tmp, "fp32_train.py")
    with open(script, "w") as fh:
        fh.write(_FP32_TRAINER)
    return _start([sys.executable, "-m", "torch.distributed.run",
                   "--standalone", "--nproc-per-node", str(ranks), script]
                  + TRAIN_ARGS + list(extra))


def _one_process_trainer(*extra) -> str:
    """The fp32 trainer on this process: its stdout."""
    real = port_configs.get_config
    port_configs.get_config = lambda name: dataclasses.replace(
        real(name), param_dtype="float32")
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            port_train.main(TRAIN_ARGS + list(extra))
    finally:
        port_configs.get_config = real
    return buf.getvalue()


def _losses(out):
    return [float(x) for x in re.findall(r"^step +\d+ loss=([0-9.]+)", out,
                                         re.M)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run the tests read, overlapped where they are independent: the
    fp32 trainer for 3 steps on 4 ranks (a checkpoint after step 2); then,
    while the reference's subprocess (its shard_map steps, and its trainer
    resuming that checkpoint to step 4) and a 2-rank resume run, the step
    cells on 4 and on 2 spawned ranks and on this process, and the
    one-process trainer (3 steps, and the same resume)."""
    tmp = str(tmp_path_factory.mktemp("dist"))
    ck = os.path.join(tmp, "ckpt4")
    four = _start_trainer(tmp, 4, "--steps", "3", "--ckpt-dir", ck,
                          "--ckpt-every", "2")
    ref_params = {arch: _ref_params(arch) for arch in ARCHS.values()}
    trainer = {"ranks4": _finish(four)}
    for name in ("resumed2", "resumed1", "ref"):
        shutil.copytree(ck, os.path.join(tmp, name))
    resume = ["--steps", "4", "--resume", "--ckpt-dir"]
    ref_dir = os.path.join(tmp, "ref_out")
    os.mkdir(ref_dir)
    code = _REFERENCE.format(
        out=ref_dir, n=N, g=G, j=J, seq=SEQ, lr=LR, archs=ARCHS, drop=DROP,
        comp_steps=COMP_STEPS,
        train_args=[a for a in TRAIN_ARGS if a not in ("--device", "cpu")]
        + resume + [os.path.join(tmp, "ref")])
    ref = _start([sys.executable, "-c", code], dict(
        os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    two = _start_trainer(tmp, 2, *resume, os.path.join(tmp, "resumed2"))
    res = {"ranks4": _run_ranks(4, os.path.join(tmp, "r4"), ref_params),
           "ranks2": _run_ranks(2, os.path.join(tmp, "r2"), ref_params)}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res["one"] = run_cells(ref_params)
    finally:
        torch.set_num_threads(threads)
    trainer["one"] = _one_process_trainer("--steps", "3")
    trainer["resumed1"] = _one_process_trainer(
        *resume, os.path.join(tmp, "resumed1"))
    trainer["resumed2"] = _finish(two)
    assert "done" in _finish(ref)
    return {**res, "trainer": trainer, "ref_dir": ref_dir}


@pytest.fixture(scope="module")
def ranks4(runs):
    return runs["ranks4"]


@pytest.fixture(scope="module")
def ranks2(runs):
    return runs["ranks2"]


@pytest.fixture(scope="module")
def one_process(runs):
    return runs["one"]


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------- #
# The mesh
# ---------------------------------------------------------------------- #
def test_workers_of_splits_the_workers_into_contiguous_runs():
    assert [list(workers_of(r, 4, 4)) for r in range(4)] == [[0], [1], [2],
                                                               [3]]
    assert [list(workers_of(r, 2, 8)) for r in range(2)] == [
        [0, 1, 2, 3], [4, 5, 6, 7]]
    assert list(workers_of(0, 1, 3)) == [0, 1, 2]
    with pytest.raises(ValueError, match="evenly"):
        workers_of(0, 4, 6)
    with pytest.raises(ValueError):
        workers_of(4, 4, 4)


def test_production_mesh_has_the_reference_shapes():
    assert make_production_mesh() == ((16, 16), ("data", "model"))
    assert make_production_mesh(multi_pod=True) == (
        (2, 16, 16), ("pod", "data", "model"))
    with pytest.raises(RuntimeError, match="initialized"):
        make_worker_mesh(4)


@pytest.mark.parametrize("world", [4, 2])
def test_worker_mesh_over_the_ranks(world, ranks4, ranks2):
    """A one-dim "data" mesh over every rank, each rank a contiguous run of
    workers; uneven splits raise. With 2 model shards a worker the mesh is
    ("data", "model") of (world / 2, 2) in the reference's device order:
    rank r is (r // 2, r % 2), its model group the ranks of its data index
    and its data group the ranks of its model index."""
    res = {4: ranks4, 2: ranks2}[world]
    k = N // world
    for r, rank in enumerate(res):
        mesh = rank["mesh"]
        assert mesh["names"] == ("data",) and mesh["size"] == world
        assert mesh["workers"] == list(range(r * k, (r + 1) * k))
        assert mesh["uneven"].startswith("ValueError")
        two = mesh["model"]
        assert two["names"] == ("data", "model")
        assert two["shape"] == (world // 2, 2)
        assert tuple(two["coords"]) == (r // 2, r % 2)
        assert two["model_ranks"] == [r - r % 2, r - r % 2 + 1]
        assert two["data_ranks"] == list(range(r % 2, world, 2))


# ---------------------------------------------------------------------- #
# The distributed step against the one-process step
# ---------------------------------------------------------------------- #
def _close(got, want, tol=1e-6):
    assert _rel(got["loss"], want["loss"]) < tol
    assert _rel(got["gnorm"], want["gnorm"]) < tol
    assert len(got["leaves"]) == len(want["leaves"])
    for a, b in zip(got["leaves"], want["leaves"]):
        assert _rel(a, b) < tol


def _bitwise(got, want, rows):
    """Parameters, moments and scales bitwise; ``got``'s error feedback
    rows are ``want``'s rows ``rows``. The loss (an fp32 sum of per-worker
    NLL sums in another order) within 1e-6."""
    assert _rel(got["loss"], want["loss"]) < 1e-6
    assert torch.equal(got["gnorm"], want["gnorm"])
    for a, b in zip(got["leaves"] + got["scale"],
                    want["leaves"] + want["scale"]):
        assert torch.equal(a, b)
    for a, b in zip(got["ef"], want["ef"]):
        assert torch.equal(a, b[rows])


@pytest.mark.parametrize("kind", list(ARCHS) + ["static"])
def test_four_ranks_equal_the_one_process_step(kind, ranks4, one_process):
    """fp32 master combine: every rank returns the one-process step's loss,
    gradient norm, parameters and moments within 1e-6 (the four totals
    summed in another order); the ranks agree with each other bitwise."""
    for rank in ranks4:
        _close(rank[kind], one_process[kind])
        for a, b in zip(rank[kind]["leaves"], ranks4[0][kind]["leaves"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("s", range(len(COMP_STEPS)))
def test_compressed_ranks_are_bitwise_the_one_process_step(s, ranks4,
                                                           one_process):
    """int8 + error feedback over two chained steps (worker 1 dropped in
    the first): each rank's parameters, moments and scales bitwise the
    one-process step's, and its worker's error feedback bitwise that
    worker's row."""
    for r, rank in enumerate(ranks4):
        _bitwise(rank[f"comp{s}"], one_process[f"comp{s}"], slice(r, r + 1))


@pytest.mark.parametrize("kind", ["dense", "moe", "recurrent", "comp1"])
def test_two_ranks_of_two_workers_equal_four_of_one(kind, ranks2, ranks4):
    """2 ranks x 2 workers against 4 x 1: fp32 within 1e-6, compressed
    bitwise (rank r of 2 holds workers 2r and 2r + 1)."""
    for r, rank in enumerate(ranks2):
        if kind.startswith("comp"):
            got = rank[kind]
            for a, b in zip(got["leaves"] + got["scale"],
                            ranks4[0][kind]["leaves"] + ranks4[0][kind]["scale"]):
                assert torch.equal(a, b)
            for i, w in enumerate((2 * r, 2 * r + 1)):
                for a, b in zip(got["ef"], ranks4[w][kind]["ef"]):
                    assert torch.equal(a[i], b[0])
        else:
            _close(rank[kind], ranks4[0][kind])


def test_the_step_counts_its_collectives(ranks4, ranks2, one_process):
    """One all-reduce of the fp32 buffers (parameters + NLL and token sums;
    one buffer at these sizes); compressed, one of the wire-dtype sums, one
    of the maxima and one of the NLL and token sums, per step. Without a
    group, none."""
    n_params = sum(t.numel() for t in one_process["dense"]["leaves"]) // 2
    n_leaves = len(one_process["dense"]["leaves"]) // 2
    for res in (ranks4, ranks2):
        stats = res[0]["stats"]
        assert stats["fp32"] == {"collectives": 1, "bytes": 4 * n_params + 8}
        assert stats["compressed"] == {
            "collectives": 3 * len(COMP_STEPS),
            "bytes": len(COMP_STEPS) * (2 * n_params + 4 * n_leaves + 8)}
    assert one_process["stats"]["fp32"] == {"collectives": 0, "bytes": 0}


# ---------------------------------------------------------------------- #
# The wire dtype
# ---------------------------------------------------------------------- #
def test_wire_dtype_holds_every_partial_sum_exactly():
    """float16 while 127 N <= 2048: every integer of magnitude <= 127 N
    survives float16 (127 x 17 = 2159 would not); int32 above, up to the
    step's limit."""
    for n in (1, 4, 16):
        assert compression.wire_dtype(n) == torch.float16
        ints = torch.arange(-127 * n, 127 * n + 1, dtype=torch.float32)
        assert torch.equal(ints.to(torch.float16).to(torch.float32), ints)
    assert float(torch.tensor(127.0 * 17).to(torch.float16)) != 127 * 17
    for n in (17, 256, 16_909_320):
        assert compression.wire_dtype(n) == torch.int32
    with pytest.raises(ValueError, match="overflow"):
        compression.wire_dtype(16_909_321)


def test_compressed_sum_refuses_error_feedback_for_other_workers():
    """The error feedback carries one row per worker this process runs: a
    one-process state (4 rows) handed to a step of 8 workers raises."""
    state = compression.init_state({"w": torch.zeros(3)}, 4)
    with pytest.raises(ValueError, match="4 workers' rows"):
        compression.CompressedSum(state, 8)
    assert compression.CompressedSum(state).wire_bytes == 0


def test_wire_sum_is_exact_at_the_int8_extremes(ranks4):
    """4 gloo ranks sum N workers' +-127 quanta (and a value clipped to
    127, and one rounded to 127) through ``CompressedSum``: exactly
    +-127 N for every N of :data:`WIRE_WORKERS`, on every rank."""
    for rank in ranks4:
        sums = rank["wire"]
        assert [(n, s) for n, s, _ in sums] == [
            (n, s) for n in WIRE_WORKERS for s in (1.0, -1.0)]
        for n, sign, got in sums:
            assert got == [sign * 127 * n] * 3


# ---------------------------------------------------------------------- #
# Against the reference's shard_map step
# ---------------------------------------------------------------------- #
def _check_reference(ref, got, quantized=False):
    """Loss, gradient norm and every first moment (0.1 x the clipped
    reduced gradient) within 1e-4 of the reference's largest value. An
    updated parameter too, where the reference's gradient is at least 1e-6
    (100 x AdamW's eps); below that AdamW's first update g / (|g| + eps)
    turns an fp32 sum-order difference in g into up to ``LR`` (the MoE
    cell's shared expert has gradients of ~2e-9), so those elements are
    held within 2 x ``LR``. Compressed steps: ``tests/test_torch_train.py``'s
    rule, at most 0.1 % of a leaf's elements on the other side of an int8
    rounding tie (2e-2)."""
    assert _rel(got["loss"], ref["loss"]) < 1e-4
    assert _rel(got["gnorm"], ref["gnorm"]) < 1e-4
    n = len(got["leaves"]) // 2
    for i, g in enumerate(got["leaves"]):
        w = ref[f"arr_{i}"]
        if quantized:
            off = np.abs(g.numpy() - w) > 1e-4 * np.abs(w).max()
            assert off.mean() <= 1e-3 and _rel(g, w) < 2e-2
            continue
        if i >= n:
            assert _rel(g, w) < 1e-4
            continue
        live = np.abs(ref[f"arr_{n + i}"]) >= 1e-7
        err = np.abs(g.numpy() - w)
        assert (err[live] <= 1e-4 * np.abs(w).max()).all()
        assert (err <= 2 * LR).all()


@pytest.mark.filterwarnings(
    "ignore:jax.nn.one_hot input should be integer-typed:DeprecationWarning")
@pytest.mark.parametrize("kind", list(ARCHS) + ["static", "comp0", "comp1"])
def test_four_ranks_match_the_reference_shard_map_step(kind, ranks4, runs):
    """Rank 0's step (worker 1 dropped; the dense cell also with
    ``static_trips`` = the list width and compressed over two chained
    steps) against the reference's on 4 forced host devices; compressed,
    also worker 0's error feedback (the reference's host copy) and the
    scales."""
    ref = _npz(os.path.join(runs["ref_dir"], f"{kind}.npz"))
    got = ranks4[0][kind]
    _check_reference(ref, got, quantized=kind.startswith("comp"))
    if kind.startswith("comp"):
        n = len(got["leaves"])
        for i, (ef, sc) in enumerate(zip(got["ef"], got["scale"])):
            want_sc = ref[f"arr_{n + len(got['ef']) + i}"]
            assert _rel(sc, want_sc) < 1e-4
            diff = np.abs(ef[0].numpy() - ref[f"arr_{n + i}"])
            assert (diff > 1e-4 * 127 * want_sc).mean() <= 1e-3


# ---------------------------------------------------------------------- #
# The trainer
# ---------------------------------------------------------------------- #
def test_four_rank_trainer_prints_the_one_process_losses(runs):
    """``python -m torch.distributed.run --nproc-per-node 4`` of the
    trainer: rank 0 alone prints the log, the same losses as one process;
    every rank reports its worker."""
    out = runs["trainer"]
    four, one = _losses(out["ranks4"]), _losses(out["one"])
    assert len(four) == len(one) == 3
    assert np.abs(np.subtract(four, one)).max() <= 1e-4
    assert out["ranks4"].count("done: 3 steps") == 1
    for r in range(4):
        assert f'rank {r} of 4: {{"workers": [{r}]' in out["ranks4"]


def test_four_rank_checkpoint_resumes_on_two_ranks_and_in_the_reference(
        runs):
    """The 4-rank run's checkpoint after step 2, resumed to step 4 on 2
    ranks, on one process and by the reference trainer: the same losses
    (the reference's last within 1e-4 relative)."""
    out, ref_dir = runs["trainer"], runs["ref_dir"]
    two, one = _losses(out["resumed2"]), _losses(out["resumed1"])
    assert "at step 2" in out["resumed2"] and len(two) == len(one) == 2
    assert np.abs(np.subtract(two, one)).max() <= 1e-4
    with open(os.path.join(ref_dir, "res.json")) as fh:
        ref = json.load(fh)["resumed4"]
    assert abs(two[-1] - ref) / abs(ref) < 1e-4 + 1e-4 / abs(ref)


def test_ranks_with_different_plans_raise(tmp_path):
    """Rank 1 flips one inclusion weight of its plan: the step-0 digest
    check raises on both ranks, before any gradient is summed."""
    tmp = str(tmp_path)
    _spawn(_mismatch_job, 2, tmp)
    for r in range(2):
        with open(os.path.join(tmp, f"mismatch{r}.txt")) as fh:
            assert "step 0: the ranks' plans differ" in fh.read()
