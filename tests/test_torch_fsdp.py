"""Parameters and optimizer state cut over the data axis: ZeRO-1 in the usec
step, the sharded fsdp step and the trainer's fsdp placement, on gloo ranks
on the CPU, against the port's unsharded steps and the JAX package's.

ZeRO-1 (``make_usec_train_step(..., reduced_grad_shardings=)``, the
moments cut by ``opt_shardings``): reduced glm4-9b and recurrentgemma-2b
in fp32 at D 2 x M 2 (the mesh) and D 2 x M 1 (two pairs of ranks), one
fp32 step and two chained compressed steps of the model-shard cell of
``tests/test_torch_tp.py``. Held to the same step without ZeRO-1 bit for
bit (the fp32 totals are reduce-scattered instead of all-reduced: the same
sums; the gradient norm accumulates in fp64); to the reference's
``make_usec_train_step(..., grad_shardings=pshard,
reduced_grad_shardings=opt_shardings(...)["m"])`` on a (2, 2) mesh of 4
forced host devices within 1e-4; each rank's ``m`` and ``v`` have exactly
the shapes ``opt_shardings``' specs cut.

The sharded fsdp step (``make_fsdp_train_step`` over the bundle's data
shards): reduced qwen1.5-110b and llama4-scout-17b-a16e in fp32 at 2 x 2,
4 rows in 2 microbatches with weights (1, 0, 1, 1) (so a microbatch's
weight scale spans both ranks' rows), one step, held to the one-process
step within 1e-5 (the MoE router's first moment, a sum of nearly
cancelling terms, within ROUTER_TOL) and to the reference's
``make_fsdp_train_step(bundle, mesh, 2, grad_shardings=pshard)`` within
1e-4 (an updated parameter where its gradient is live, as
``tests/test_torch_tp.py`` holds it). AdamW in runs and in place, and
the donating fsdp step, equal the whole-leaf and copying ones bit for
bit.

``gather_from_data`` alone: forward the whole leaf, backward this rank's
slice of the ranks' summed gradients (fp32 and bf16: summed in fp32,
rounded once). The trainer at 2 x 2 for reduced qwen1.5-110b (fsdp mode):
every rank rests with the fsdp rules' cut (its resting bytes), its losses
equal the 1 x 4 run's within 1e-5; its checkpoint, and one written under
ZeRO-1, resume at 1 x 4 and in one process with the saved whole leaves
bit for bit.
"""

import contextlib
import dataclasses
import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import REPO, SRC  # noqa: E402
from test_torch_tp import (  # noqa: E402
    LR,
    N,
    TOL,
    REF_TOL,
    _args,
    _cell,
    _held,
    _quantized,
    _ref_params,
    _rel,
    _report,
    _spawn,
)

from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import demo_batch  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    MeshSpec,
    coordinates,
    data_group,
    make_worker_mesh,
    model_group,
)
from repro_torch.models import build_model, params_from_reference  # noqa: E402
from repro_torch.models.parallel import (  # noqa: E402
    DataShards,
    ModelShards,
    meta_params,
    data_dims,
    gather_from_data,
    shard_params,
    unshard_params,
)
from repro_torch.models.transformer import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import checkpoint as ckpt  # noqa: E402
from repro_torch.runtime import compression  # noqa: E402
from repro_torch.runtime.trainstep import (  # noqa: E402
    make_fsdp_train_step,
    make_usec_train_step,
)

ZERO_ARCHS = {"dense": "glm4-9b", "recurrent": "recurrentgemma-2b"}
FSDP_ARCHS = {"dense": "qwen1.5-110b", "moe": "llama4-scout-17b-a16e"}
MESHES = {"2x2": (2, 2), "2x1": (2, 1)}
# The fsdp cell: 4 rows of 32 tokens, 2 microbatches of 2 rows.
FSDP_B, FSDP_S, FSDP_MICRO = 4, 32, 2
FSDP_WEIGHTS = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
COMP_STEPS = (0, 1)
TRAIN_ARGS = ["--arch", "qwen1.5-110b", "--reduced", "--workers", "2",
              "--seq-len", "32", "--tile-samples", "1",
              "--straggler-tolerance", "1", "--drop-stragglers", "1",
              "--log-every", "1", "--device", "cpu", "--steps", "4"]


def _fsdp_cfg(arch):
    return dataclasses.replace(get_config(arch).reduced(),
                               param_dtype="float32")


def _fsdp_batch(cfg):
    return demo_batch(cfg, "train", FSDP_B, FSDP_S, seed=3)


def _zero1_specs(cfg, d, m):
    """``opt_shardings``' moment specs on a (d, m) mesh, as a tree."""
    mesh = MeshSpec((d, m), ("data", "model"))
    shapes = meta_params(cfg)
    return sharding.opt_shardings(
        sharding.param_shardings(shapes, cfg, mesh), mesh, shapes)["m"]


# ---------------------------------------------------------------------- #
# The ranks
# ---------------------------------------------------------------------- #
def run_zero1(ref_params, dgroup, d, shards):
    """Each ZeRO-1 cell on this rank's groups, with and without ZeRO-1:
    losses, norms, the whole updated parameters and first moments, the
    local moment shapes; compressed: also the scales and this rank's
    error feedback."""
    out = {}
    n_model, m = (1, 0) if shards is None else (shards.size, shards.rank)
    dp = DataShards(dgroup, 2, d)
    for kind, arch in ZERO_ARCHS.items():
        cfg, pipe, plan, b_max = _cell(arch)
        bundle = build_model(cfg, device="cpu", shards=shards)
        params = params_from_reference(ref_params[arch], cfg, "cpu", shards)
        whole_m = params_from_reference(ref_params[arch], cfg, "cpu")
        specs = _zero1_specs(cfg, 2, n_model)

        def moments():
            return adamw.init(shard_params(whole_m, cfg, n_model, m, 2, d,
                                           moments=True))

        def whole(tree):
            return tree_leaves(unshard_params(tree, cfg, shards, dp=dp))

        for zero1 in (False, True):
            rgs = specs if zero1 else None
            step = make_usec_train_step(bundle, pipe.t_stage, b_max,
                                        group=dgroup,
                                        reduced_grad_shardings=rgs)
            opt = moments() if zero1 else adamw.init(params)
            new_p, new_o, _, met = step(params, opt, None,
                                        *_args(pipe, plan, b_max))
            out[kind, zero1] = {
                "loss": met["loss"], "gnorm": met["grad_norm"],
                "leaves": whole(new_p) + whole(new_o["m"]),
                "m_shapes": [tuple(t.shape) for t in tree_leaves(new_o["m"])],
                "v_shapes": [tuple(t.shape) for t in tree_leaves(new_o["v"])],
                "state": (new_p, new_o) if zero1 and kind == "dense" else None}
            comp_step = make_usec_train_step(bundle, pipe.t_stage, b_max,
                                             compress_grads=True,
                                             group=dgroup,
                                             reduced_grad_shardings=rgs)
            p, o = params, (moments() if zero1 else adamw.init(params))
            comp = compression.init_state(p, N // 2)
            for s, data in enumerate(COMP_STEPS):
                p, o, comp, met = comp_step(p, o, comp,
                                            *_args(pipe, plan, b_max, data))
                out[f"{kind}_comp{s}", zero1] = {
                    "loss": met["loss"], "gnorm": met["grad_norm"],
                    "leaves": whole(p) + whole(o["m"]),
                    "ef": tree_leaves(comp["ef"]),
                    "scale": tree_leaves(comp["scale"])}
    return out


def run_fsdp(ref_params, shards=None, data=None):
    """One step of each fsdp cell (this rank's groups, or one process):
    loss, norm, the whole updated parameters and first moments, and the
    layers' data-group collectives."""
    out = {}
    n_model, m = (1, 0) if shards is None else (shards.size, shards.rank)
    n_data, d = (1, 0) if data is None else (data.size, data.rank)
    for kind, arch in FSDP_ARCHS.items():
        cfg = _fsdp_cfg(arch)
        if data is not None:
            data = DataShards(data.group, n_data, d)
        bundle = build_model(cfg, device="cpu", shards=shards, data=data)
        whole = params_from_reference(ref_params[arch], cfg, "cpu")
        params = shard_params(whole, cfg, n_model, m, n_data, d)
        opt = adamw.init(shard_params(whole, cfg, n_model, m, n_data, d,
                                      moments=True))
        step = make_fsdp_train_step(bundle, FSDP_MICRO)
        new_p, new_o, met = step(params, opt, _fsdp_batch(cfg), FSDP_WEIGHTS,
                                 LR)
        out[kind] = {
            "loss": met["loss"], "gnorm": met["grad_norm"],
            "leaves": tree_leaves(unshard_params(new_p, cfg, shards, dp=data))
            + tree_leaves(unshard_params(new_o["m"], cfg, shards, dp=data)),
            "data_stats": None if data is None else dict(data.stats),
            "step_stats": dict(step.stats)}
    return out


def run_gather(dgroup, d):
    """gather_from_data over the data group along dim 1 of a (3, 4) leaf:
    (the whole leaf, this rank's gradient) in fp32 and bf16; each rank's
    upstream gradient is its own draw."""
    out = {}
    dp = DataShards(dgroup, 2, d)
    for dt in (torch.float32, torch.bfloat16):
        gen = torch.Generator().manual_seed(11)
        whole = torch.randn((3, 4), generator=gen).to(dt)
        x = whole[:, 2 * d:2 * d + 2].clone().requires_grad_()
        y = gather_from_data(x, dp, 1)
        g = torch.randn((3, 4), generator=torch.Generator().manual_seed(
            20 + d)).to(dt)
        (gx,) = torch.autograd.grad(y, x, g)
        out[str(dt)] = (y.detach(), gx)
    return out


def _trainer(argv) -> str:
    real = port_configs.get_config
    port_configs.get_config = lambda name: dataclasses.replace(
        real(name), param_dtype="float32")
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            port_train.main(TRAIN_ARGS + list(argv))
    finally:
        port_configs.get_config = real
    return buf.getvalue()


def _fresh_dir(path, latest=None):
    """A copy of checkpoint dir ``path`` whose LATEST names ``latest``."""
    out = path + f"_{latest}"
    shutil.copytree(path, out)
    if latest is not None:
        with open(os.path.join(out, "LATEST"), "w") as fh:
            fh.write(latest)
    return out


def _restore14(path, cfg, mesh14, ref_params):
    """A checkpoint restored at 1 x 4 (this rank's cut), then gathered
    whole: params + m + v leaves."""
    _, m = coordinates(mesh14)
    shards = ModelShards(model_group(mesh14), 4, m)
    params = params_from_reference(ref_params, cfg, "cpu", shards)
    _, p, o, _ = ckpt.restore_train_state(path, params, adamw.init(params),
                                          cfg, shards)
    return [t for tree in (p, o["m"], o["v"])
            for t in tree_leaves(unshard_params(tree, cfg, shards))]


def _rank_job(rank, world, store, out_dir, ref_params):
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        dist = torch.distributed
        pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        mesh = make_worker_mesh(N, 2)
        d, m = coordinates(mesh)
        shards = ModelShards(model_group(mesh), 2, m)
        res = {"coords": (d, m)}
        res["zero1", "2x2"] = run_zero1(ref_params, data_group(mesh), d,
                                        shards)
        res["zero1", "2x1"] = run_zero1(ref_params, pairs[rank // 2],
                                        rank % 2, None)
        res["fsdp"] = run_fsdp(ref_params, shards,
                               DataShards(data_group(mesh), 2, d))
        res["gather"] = run_gather(data_group(mesh), d)
        # ZeRO-1's state (dense, fp32 step) saved at 2 x 2, restored at 1 x 4.
        cfg = _cell(ZERO_ARCHS["dense"])[0]
        new_p, new_o = res["zero1", "2x2"]["dense", True].pop("state")
        for mesh_name in MESHES:
            for key in list(res["zero1", mesh_name]):
                res["zero1", mesh_name][key].pop("state", None)
        zdir = os.path.join(out_dir, "zero1_ckpt")
        ckpt.save_train_state(zdir, 1, new_p, new_o, cfg, shards,
                              write=rank == 0,
                              data=DataShards(data_group(mesh), 2, d))
        dist.barrier()
        mesh14 = make_worker_mesh(N, 4)
        res["zero1_restored14"] = _restore14(
            os.path.join(zdir, "step_000000001"), cfg, mesh14,
            ref_params[ZERO_ARCHS["dense"]])
        # The trainer: 4 steps at 2 x 2 (checkpoints after steps 2 and 4),
        # 4 steps at 1 x 4, and step 2's checkpoint resumed at 1 x 4.
        tdir = os.path.join(out_dir, "train22")
        res["train22"] = _trainer(["--model-shards", "2", "--ckpt-dir", tdir,
                                   "--ckpt-every", "2"])
        res["train14"] = _trainer(["--model-shards", "4"])
        dist.barrier()
        if rank == 0:
            _fresh_dir(tdir, "step_000000002")
        dist.barrier()
        res["resumed14"] = _trainer(["--model-shards", "4", "--resume",
                                     "--ckpt-dir", tdir + "_step_000000002"])
        qcfg = dataclasses.replace(get_config("qwen1.5-110b").reduced(),
                                   param_dtype="float32")
        res["fsdp_restored14"] = _restore14(
            os.path.join(tdir, "step_000000002"), qcfg, mesh14,
            ref_params["qwen1.5-110b"])
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _one_rank_job(rank, world, store, out_dir):
    """The fsdp placement's step-2 checkpoint resumed by one rank."""
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        out = _trainer(["--resume", "--ckpt-dir", os.path.join(
            out_dir, "train22_step_000000002")])
        with open(os.path.join(out_dir, "resumed11.txt"), "w") as fh:
            fh.write(out)
    finally:
        torch.distributed.destroy_process_group()


_REFERENCE = r"""
import dataclasses, os, warnings
import numpy as np, jax, jax.numpy as jnp
import repro.configs as rc
from repro.configs.shapes import demo_batch
from repro.core import cyclic_placement, solve_assignment, compile_plan
from repro.data import TokenPipeline
from repro.launch import sharding as shr
from repro.launch.mesh import make_worker_mesh
from repro.jax_compat import set_mesh
from repro.models import build_model
from repro.optim import adamw
from repro.runtime import compression
from repro.runtime.executor import block_plan
from repro.runtime.trainstep import make_fsdp_train_step, make_usec_train_step

warnings.simplefilter("ignore", DeprecationWarning)
OUT = {out!r}
N, G, J, SEQ, LR = {n}, {g}, {j}, {seq}, {lr}
ZERO, FSDP, COMP_STEPS = {zero!r}, {fsdp!r}, {comp_steps!r}
B, S, MICRO, WEIGHTS = {b}, {s}, {micro}, {weights!r}
flat = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]
mesh = make_worker_mesh(N, 2)
key = jax.random.PRNGKey(0)

def save(name, m, p, o, extra=()):
    np.savez(os.path.join(OUT, name + ".npz"), loss=np.asarray(m["loss"]),
             gnorm=np.asarray(m["grad_norm"]),
             *(flat(p) + flat(o["m"]) + list(extra)))

def placed(cfg):
    bundle = build_model(cfg)
    shapes = jax.eval_shape(bundle.init, key)
    pshard = shr.param_shardings(shapes, cfg, mesh)
    oshard = shr.opt_shardings(pshard, mesh, shapes)
    place = lambda: jax.device_put(bundle.init(key), pshard)
    return bundle, pshard, oshard, place

with set_mesh(mesh):
    for kind, arch in ZERO.items():
        cfg = dataclasses.replace(rc.get_config(arch).reduced(),
                                  param_dtype="float32",
                                  grad_accum_dtype="float32")
        bundle, pshard, oshard, place = placed(cfg)
        p = cyclic_placement(N, G, J)
        pipe = TokenPipeline(cfg, p, seq_len=SEQ, tile_samples=1, seed=0)
        plan = compile_plan(p, solve_assignment(p, np.ones(N), stragglers=1),
                            rows_per_tile=1, stragglers=1)
        b_max = int(plan.n_valid.max()) + 1

        def args(s):
            sb = pipe.staged_for_step(s)
            bp = block_plan(plan, sb.slot_of, 1, stragglers=(), b_max=b_max)
            return ({{k: jnp.asarray(v) for k, v in sb.arrays.items()}},
                    jnp.asarray(bp.blk_slot), jnp.asarray(bp.blk_include),
                    jnp.asarray(bp.n_blocks)[:, None], jnp.float32(LR))

        def opt(params):
            return jax.device_put(adamw.init(params), oshard)

        step = make_usec_train_step(bundle, mesh, pipe.t_stage, b_max,
                                    grad_shardings=pshard,
                                    reduced_grad_shardings=oshard["m"])
        params = place()
        new_p, new_o, _, m = step(params, opt(params), None, *args(0))
        save(kind, m, new_p, new_o)
        step = make_usec_train_step(bundle, mesh, pipe.t_stage, b_max,
                                    compress_grads=True, grad_shardings=pshard,
                                    reduced_grad_shardings=oshard["m"])
        pr = place()
        op, cs = opt(pr), compression.init_state(pr)
        for s, data in enumerate(COMP_STEPS):
            pr, op, cs, m = step(pr, op, cs, *args(data))
            save(f"{{kind}}_comp{{s}}", m, pr, op,
                 flat(cs["ef"]) + flat(cs["scale"]))
    for kind, arch in FSDP.items():
        cfg = dataclasses.replace(rc.get_config(arch).reduced(),
                                  param_dtype="float32")
        bundle, pshard, oshard, place = placed(cfg)
        params = place()
        opt = jax.device_put(adamw.init(params), oshard)
        step = make_fsdp_train_step(bundle, mesh, MICRO, grad_shardings=pshard)
        batch = {{k: jnp.asarray(v)
                 for k, v in demo_batch(cfg, "train", B, S, seed=3).items()}}
        new_p, new_o, m = step(params, opt, batch, jnp.asarray(WEIGHTS),
                               jnp.float32(LR))
        save(f"fsdp_{{kind}}", m, new_p, new_o)
print("done")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess, the 4 ranks, the one-rank resume and
    this process's one-process fsdp steps, overlapped."""
    tmp = str(tmp_path_factory.mktemp("fsdp"))
    ref_dir = os.path.join(tmp, "ref")
    os.mkdir(ref_dir)
    from test_torch_tp import G, J, SEQ

    code = _REFERENCE.format(
        out=ref_dir, n=N, g=G, j=J, seq=SEQ, lr=LR, zero=ZERO_ARCHS,
        fsdp=FSDP_ARCHS, comp_steps=COMP_STEPS, b=FSDP_B, s=FSDP_S,
        micro=FSDP_MICRO, weights=FSDP_WEIGHTS.tolist())
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    ref = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True, env=env,
                           cwd=REPO)
    ref_params = {arch: _ref_params(arch) for arch in
                  list(ZERO_ARCHS.values()) + list(FSDP_ARCHS.values())}
    _spawn(_rank_job, 4, tmp, ref_params)
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(4)]
    _spawn(_one_rank_job, 1, tmp)
    with open(os.path.join(tmp, "resumed11.txt")) as fh:
        resumed11 = fh.read()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = run_fsdp(ref_params)
    finally:
        torch.set_num_threads(threads)
    out, err = ref.communicate(timeout=560)
    assert ref.returncode == 0 and "done" in out, err[-3000:]
    return {"ranks": ranks, "one": one, "ref_dir": ref_dir, "tmp": tmp,
            "ref_params": ref_params, "resumed11": resumed11}


def _ref(runs, name, n=None):
    with np.load(os.path.join(runs["ref_dir"], f"{name}.npz")) as z:
        k = len(z.files) - 2
        out = {"loss": z["loss"], "gnorm": z["gnorm"],
               "leaves": [z[f"arr_{i}"] for i in range(k)]}
    if n is not None:
        out["extra"], out["leaves"] = out["leaves"][n:], out["leaves"][:n]
    return out


# ---------------------------------------------------------------------- #
# ZeRO-1
# ---------------------------------------------------------------------- #
def _bitwise(got, want):
    return all(torch.equal(a, b) for a, b in zip(
        [got["loss"], got["gnorm"]] + got["leaves"] + got.get("ef", [])
        + got.get("scale", []),
        [want["loss"], want["gnorm"]] + want["leaves"] + want.get("ef", [])
        + want.get("scale", [])))


@pytest.mark.parametrize("step", ["fp32"] + [f"comp{s}" for s in COMP_STEPS])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("kind", list(ZERO_ARCHS))
def test_zero1_equals_the_step_without_it(kind, mesh, step, runs):
    """Every rank's loss, gradient norm, gathered parameters and first
    moments (and, compressed, its scales and error feedback, over two
    chained steps) bitwise those of the same step without ZeRO-1 on the
    same ranks: a reduce-scatter over two ranks adds the same two fp32
    totals as the all-reduce, the compressed sum is exact, and the norm
    accumulates in fp64, so the slices' squares round to the same fp32 norm
    and the clip scale is the same (the issue's bound is 1e-6)."""
    name = kind if step == "fp32" else f"{kind}_{step}"
    for rank in runs["ranks"]:
        got = rank["zero1", mesh][name, True]
        assert len(got["leaves"]) == len(rank["zero1", mesh][name, False]
                                         ["leaves"])
        assert _bitwise(got, rank["zero1", mesh][name, False])
        assert torch.equal(got["loss"],
                           runs["ranks"][0]["zero1", mesh][name, True]["loss"])


@pytest.mark.filterwarnings(
    "ignore:jax.nn.one_hot input should be integer-typed:DeprecationWarning")
@pytest.mark.parametrize("step", ["fp32"] + [f"comp{s}" for s in COMP_STEPS])
@pytest.mark.parametrize("kind", list(ZERO_ARCHS))
def test_zero1_equals_the_reference(kind, step, runs):
    """Rank 0's ZeRO-1 step at 2 x 2 against the reference's on a (2, 2)
    mesh with ``reduced_grad_shardings``: 1e-4 (fp32), the quantizer's
    rounding-tie rule (compressed; the scales 1e-4)."""
    name = kind if step == "fp32" else f"{kind}_{step}"
    got = runs["ranks"][0]["zero1", "2x2"][name, True]
    ref = _ref(runs, name, len(got["leaves"]))
    if step == "fp32":
        _held(got, ref, REF_TOL)
        return
    _quantized(got, ref, REF_TOL)
    scales = ref["extra"][len(got["ef"]):]
    for a, b in zip(got["scale"], scales):
        assert _rel(a, b) < REF_TOL


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("kind", list(ZERO_ARCHS))
def test_zero1_moments_have_the_opt_shardings_cut(kind, mesh, runs):
    """Each rank's ``m`` and ``v`` leaves have the shape ``opt_shardings``'
    specs cut from the whole leaf (over data and over model), and some
    leaf is cut over data that the parameters keep whole."""
    d_size, m_size = MESHES[mesh]
    cfg = _cell(ZERO_ARCHS[kind])[0]
    specs = sharding.leaves(_zero1_specs(cfg, d_size, m_size))
    sizes = {"data": d_size, "model": m_size}
    want = []
    for spec, t in zip(specs, tree_leaves(meta_params(cfg))):
        shape = list(t.shape)
        for i, e in enumerate(spec):
            if e is not None:
                shape[i] //= sizes[e]
        want.append(tuple(shape))
    assert any(sharding.data_dim(s) is not None for s in specs)
    for rank in runs["ranks"]:
        got = rank["zero1", mesh][kind, True]
        assert got["m_shapes"] == want and got["v_shapes"] == want


def test_zero1_cuts_the_stacked_layer_axis_and_whole_fsdp_leaves():
    """The moment dims follow the reference's ZeRO-1 rule: glm4-9b's
    stacked ``w_down`` (2, 96, 64) is cut over data on its layer axis; in
    fsdp mode ``final_norm`` (64,) and the MoE router are cut though their
    parameters are whole."""
    def keyed(cfg, **kw):
        keys = []
        sharding.map_with_path(lambda p, _: keys.append(sharding.keystr(p)),
                               meta_params(cfg))
        return dict(zip(keys, data_dims(cfg, 2, 2, **kw)))

    cfg = _cell("glm4-9b")[0]
    assert keyed(cfg, moments=True)[
        "['stack']['blocks'][0]['ffn']['w_down']"] == 0
    assert set(keyed(cfg).values()) == {None}  # usec: params whole
    moe = _fsdp_cfg("llama4-scout-17b-a16e")
    pd, md = keyed(moe), keyed(moe, moments=True)
    for key in ("['final_norm']['scale']",
                "['stack']['blocks'][0]['ffn']['router']"):
        assert pd[key] is None and md[key] == 0
    assert pd["['stack']['blocks'][0]['temporal']['wq']"] == 1
    assert pd["['stack']['blocks'][0]['temporal']['wo']"] == 2
    assert pd["['embed']"] == 1 and pd["['unembed']"] == 0


# ---------------------------------------------------------------------- #
# The sharded fsdp step
# ---------------------------------------------------------------------- #
# The MoE router's first moment, a sum of nearly cancelling terms, moves
# by up to 2.5e-5 of its largest value between any two fp32 summation
# orders: the one-process port against the reference shows 2.48e-5, the
# 2 x 2 step against the one-process step 1.48e-5. It alone is held at
# ROUTER_TOL; every other leaf at 1e-5.
ROUTER_TOL = 1e-4


def _held_fsdp(got, want, tol, arch):
    """:func:`_held`, with the MoE router's first moment held at
    ROUTER_TOL instead."""
    keys = []
    sharding.map_with_path(lambda p, _: keys.append(sharding.keystr(p)),
                           meta_params(_fsdp_cfg(arch)))
    router = [len(keys) + i for i, k in enumerate(keys)
              if k.endswith("['router']")]
    leaves = list(got["leaves"])
    for i in router:
        assert _rel(leaves[i], want["leaves"][i]) < ROUTER_TOL
        leaves[i] = want["leaves"][i]
    _held(dict(got, leaves=leaves), want, tol)


@pytest.mark.parametrize("kind", list(FSDP_ARCHS))
def test_fsdp_step_equals_the_one_process_step(kind, runs):
    """Every rank's loss, norm, gathered parameters and first moments
    within 1e-5 of the one-process step (the MoE router's first moment
    within ROUTER_TOL); the layers gathered and reduce-scattered over the
    data group."""
    want = runs["one"][kind]
    for rank in runs["ranks"]:
        got = rank["fsdp"][kind]
        _held_fsdp(got, want, TOL, FSDP_ARCHS[kind])
        assert got["data_stats"]["collectives"] > 0
        assert got["step_stats"]["collectives"] > 0


@pytest.mark.filterwarnings(
    "ignore:jax.nn.one_hot input should be integer-typed:DeprecationWarning")
@pytest.mark.parametrize("kind", list(FSDP_ARCHS))
def test_fsdp_step_equals_the_reference(kind, runs):
    """Rank 0's sharded fsdp step against the reference's
    ``make_fsdp_train_step(..., grad_shardings=pshard)`` on a (2, 2) mesh,
    and the one-process step against it too: 1e-4."""
    got = runs["ranks"][0]["fsdp"][kind]
    ref = _ref(runs, f"fsdp_{kind}")
    _held(got, ref, REF_TOL)
    _held(runs["one"][kind], ref, REF_TOL)


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
def test_gather_from_data_forward_and_backward(dtype, runs):
    """Forward: every rank the whole leaf. Backward: each rank its slice
    of the two ranks' summed upstream gradients, summed in fp32 and
    rounded once to the dtype."""
    dt = getattr(torch, dtype.split(".")[1])
    whole = torch.randn((3, 4), generator=torch.Generator().manual_seed(
        11)).to(dt)
    gs = [torch.randn((3, 4), generator=torch.Generator().manual_seed(
        20 + d)).to(dt) for d in range(2)]
    total = (gs[0].float() + gs[1].float()).to(dt)
    for rank in runs["ranks"]:
        d = rank["coords"][0]
        y, gx = rank["gather"][dtype]
        assert torch.equal(y, whole)
        assert gx.dtype == dt and torch.equal(gx, total[:, 2 * d:2 * d + 2])


# ---------------------------------------------------------------------- #
# The trainer's fsdp placement; checkpoints across layouts
# ---------------------------------------------------------------------- #
def _resting_bytes(cfg, n_data, n_model, d, m):
    """Parameters + both moments of one rank under the fsdp rules."""
    full = meta_params(cfg)
    local = tree_leaves(shard_params(full, cfg, n_model, m, n_data, d))
    return sum(t.numel() * (t.element_size() + 8) for t in local)


def test_trainer_rests_cut_over_data_and_equals_one_by_four(runs):
    """``main --model-shards 2`` on 4 ranks (reduced qwen1.5-110b, fsdp
    mode): each rank's parameters and moments rest with the fsdp rules'
    cut over (data, model), less than the 1 x 4 run holds with the data
    entries whole for the same model shard count; its losses and norms
    equal the 1 x 4 run's within 1e-5."""
    cfg = _fsdp_cfg("qwen1.5-110b")
    out22, out14 = runs["ranks"][0]["train22"], runs["ranks"][0]["train14"]
    for r in range(4):
        rep = _report(out22, r, 4)
        d, m = divmod(r, 2)
        assert rep["resting_bytes"] == _resting_bytes(cfg, 2, 2, d, m)
    assert _resting_bytes(cfg, 2, 2, 0, 0) < _resting_bytes(cfg, 1, 2, 0, 0)
    full, four = _report(out22, 0, 4), _report(out14, 0, 4)
    assert len(full["losses"]) == 4
    assert _rel(full["losses"], four["losses"]) < TOL
    assert _rel(full["grad_norms"], four["grad_norms"]) < TOL
    assert full["reduced_bytes"] > 0


def _whole_checkpoint(path, cfg, ref_params):
    """A checkpoint restored in one process: params + m + v leaves."""
    params = params_from_reference(ref_params, cfg, "cpu")
    _, p, o, _ = ckpt.restore_train_state(path, params, adamw.init(params),
                                          cfg)
    return tree_leaves(p) + tree_leaves(o["m"]) + tree_leaves(o["v"])


@pytest.mark.parametrize("layout", ["zero1", "fsdp"])
def test_checkpoint_resumes_across_layouts_bitwise(layout, runs):
    """A checkpoint written at 2 x 2 (ZeRO-1's usec state, or the trainer's
    fsdp placement after step 2) holds whole leaves; restored at 1 x 4 and
    gathered, and restored in one process, they are those leaves bit for
    bit (ZeRO-1: the step's gathered parameters and moments). The trainer
    resumed from the fsdp placement's checkpoint at 1 x 4 and in one
    process runs steps 2 and 3 with the 2 x 2 run's losses (1e-5)."""
    if layout == "zero1":
        arch = ZERO_ARCHS["dense"]
        cfg = _cell(arch)[0]
        path = os.path.join(runs["tmp"], "zero1_ckpt", "step_000000001")
    else:
        arch = "qwen1.5-110b"
        cfg = _fsdp_cfg(arch)
        path = os.path.join(runs["tmp"], "train22", "step_000000002")
    whole = _whole_checkpoint(path, cfg, runs["ref_params"][arch])
    for rank in runs["ranks"]:
        got = rank[f"{layout}_restored14"]
        assert len(got) == len(whole)
        assert all(torch.equal(a, b) for a, b in zip(got, whole))
    if layout == "zero1":
        n = len(whole) // 3
        state = runs["ranks"][0]["zero1", "2x2"]["dense", True]["leaves"]
        assert all(torch.equal(a, b) for a, b in zip(whole[:2 * n], state))
        return
    full = _report(runs["ranks"][0]["train22"], 0, 4)
    for out, world in ((runs["ranks"][0]["resumed14"], 4),
                       (runs["resumed11"], 1)):
        assert "at step 2" in out
        rep = _report(out, 0, world)
        assert _rel(rep["losses"], full["losses"][2:]) < TOL
        assert _rel(rep["grad_norms"], full["grad_norms"][2:]) < TOL


# ---------------------------------------------------------------------- #
# AdamW in runs and in place; the donating fsdp step
# ---------------------------------------------------------------------- #
def test_adamw_runs_and_in_place_update_equal_the_whole_leaf_update(
        monkeypatch):
    """The update in runs of a few rows (``CHUNK``) and in place gives the
    whole-leaf update's parameters and moments bit for bit (bf16 and fp32
    leaves, a matrix and a vector); in place it returns the given
    tensors."""
    gen = torch.Generator().manual_seed(5)
    params = {"w": torch.randn((37, 9), generator=gen).to(torch.bfloat16),
              "b": torch.randn((9,), generator=gen)}
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen), params)
    state = adamw.init(params)
    state = dict(state, m=tree_map(lambda m: m + 0.01, state["m"]),
                 v=tree_map(lambda v: v + 0.02, state["v"]))
    want = adamw.update(grads, state, params, 1e-3)
    monkeypatch.setattr(adamw, "CHUNK", 20)
    runs = adamw.update(grads, state, params, 1e-3)
    copy = lambda t: tree_map(torch.clone, t)
    mine_p = copy(params)
    mine_s = dict(state, m=copy(state["m"]), v=copy(state["v"]))
    done = adamw.update(grads, mine_s, mine_p, 1e-3, inplace=True)
    for got in (runs, done):
        for a, b in zip(tree_leaves(got[:2]), tree_leaves(want[:2])):
            assert torch.equal(a, b)
    assert done[0]["w"] is mine_p["w"] and done[1]["m"]["w"] is \
        mine_s["m"]["w"]


def test_donating_fsdp_step_equals_the_step_that_copies():
    """One process: ``make_fsdp_train_step(..., donate=True)`` returns the
    same parameters, moments and metrics bit for bit, in the tensors it was
    given."""
    cfg = _fsdp_cfg("qwen1.5-110b")
    bundle = build_model(cfg, device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    batch = _fsdp_batch(cfg)
    want = make_fsdp_train_step(bundle, FSDP_MICRO)(
        params, adamw.init(params), batch, FSDP_WEIGHTS, LR)
    given = tree_map(torch.clone, params)
    got = make_fsdp_train_step(bundle, FSDP_MICRO, donate=True)(
        given, adamw.init(given), batch, FSDP_WEIGHTS, LR)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)
    assert all(a is b for a, b in zip(tree_leaves(got[0]),
                                      tree_leaves(given)))
