"""The sequence-parallel residual stream (``cfg.act_shard_axis``, the
reference's ``_seq_shard``): between sublayers each rank of a model group
holds its ``⌈S/M⌉`` of the residual's positions. On gloo ranks on the CPU,
against the same steps without it and against the JAX package's GSPMD
step.

* The primitives at M = 2, fp32 and bf16, at an S that M divides and one
  it does not: ``reduce_scatter_to_model`` (forward this rank's slice of
  the ranks' fp32 sum rounded once, the last slice zero-padded; backward
  the ranks' gradients joined and trimmed to S), ``gather_from_model``
  with the whole ``size`` and ``slice_to_model`` (forward and backward).
* The sharded fsdp step at D 2 x M 2 (reduced qwen1.5-110b and
  llama4-scout-17b-a16e in fp32, ``tests/test_torch_fsdp.py``'s cell: 4
  rows of 32 positions in 2 microbatches, weights (1, 0, 1, 1)) with the
  axis against the same step without it: loss, norm, every updated
  parameter and first moment within 1e-5 (the ``_held`` rule). It is not
  bitwise in fp32: the forward is (the two ranks' partial sums add in
  either order to the same fp32 values), but a residual's gradient sums
  the residual branch and the norm's uses of its input in another order
  (in fp32 the norm's ``x.to(float32)`` is ``x`` itself, so the norm's
  squares and product are further terms of that sum; a gathered input
  sums them first). Every leaf the norms' inputs feed differs in its last
  bits; with the norm reading its input once, every leaf is bitwise.
* The same step against the reference's ``make_fsdp_train_step`` on a
  (2, 2) mesh of 4 forced host devices with ``act_shard_axis="model"``
  and ``act_batch_axes=("data",)``: 1e-4 (the MoE router's moment at
  ``ROUTER_TOL``).
* The MoE under the axis: each rank's (E/M, C, D) dispatch buffers equal
  the same ranks' without the axis bit for bit and the one-process
  buffers' slice of this rank's experts within 1e-5, with equal routes.
* An S that M does not divide (31 positions), against the step without
  the axis.
* The usec step at D 1 x M 2 with an explicit ``act_shard_axis="model"``
  (reduced glm4-9b, recurrentgemma-2b, mamba2-370m in fp32: attention, the
  RG-LRU scan and the SSD chunk scan on the gathered whole), against the
  same step without it.
* The dry-run's trace of the fsdp step with the axis on a fake 2 x 2
  group: its model- and data-group bytes equal the gloo ranks' ``stats``.
* The live bytes at the end of a microbatch's forward (reduced
  qwen1.5-110b on a fake 1 x 2 group, meta tensors) fall with the axis by
  exactly (M-1)/M of the residual boundaries the remat policy keeps.

The ranks are spawned processes meeting in a file store under the test's
temporary directory, one thread each; the reference runs in one
subprocess, overlapped with them.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import REPO, SRC  # noqa: E402
from test_torch_fsdp import (  # noqa: E402
    FSDP_ARCHS,
    FSDP_B,
    FSDP_MICRO,
    FSDP_S,
    FSDP_WEIGHTS,
    ROUTER_TOL,
    _held_fsdp,
)
from test_torch_tp import (  # noqa: E402
    LR,
    N,
    REF_TOL,
    TOL,
    _args,
    _cell,
    _held,
    _ref_params,
    _rel,
    _spawn,
)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import batch_schema, demo_batch  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    MeshSpec,
    coordinates,
    data_group,
    make_worker_mesh,
    model_group,
)
from repro_torch.launch.op_cost import MemoryTracker, traced  # noqa: E402
from repro_torch.models import build_model, moe as moe_mod  # noqa: E402
from repro_torch.models import params_from_reference  # noqa: E402
from repro_torch.models.parallel import (  # noqa: E402
    DataShards,
    ModelShards,
    gather_from_model,
    reduce_scatter_to_model,
    seq_cut,
    shard_params,
    slice_to_model,
    unshard_params,
)
from repro_torch.models.transformer import tree_leaves  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.trainstep import (  # noqa: E402
    make_fsdp_train_step,
    make_usec_train_step,
)

M = 2
UNEVEN_S = 31  # positions M does not divide
USEC_ARCHS = ("glm4-9b", "recurrentgemma-2b", "mamba2-370m")
PRIM_SIZES = (8, 7)  # the primitives' S: divided by M, and not
PRIM_DTYPES = ("float32", "bfloat16")
AXES = ("", "model")  # off, on


def _axis_cfg(arch, axis, reduced_fp32=True):
    """``arch``'s reduced config in fp32 with the axis set as the
    reference's dry-run sets it for an fsdp cell (``""``: off)."""
    cfg = get_config(arch).reduced()
    if reduced_fp32:
        cfg = dataclasses.replace(cfg, param_dtype="float32")
    return dataclasses.replace(cfg, act_shard_axis=axis,
                               act_batch_axes=("data",) if axis else ())


# ---------------------------------------------------------------------- #
# The ranks
# ---------------------------------------------------------------------- #
def _draw(seed, shape, dt):
    return torch.randn(shape, generator=torch.Generator().manual_seed(
        seed)).to(dt)


def run_primitives(group, m):
    """Each primitive at M = 2 along dim 1 of a (2, S, 3) tensor, every
    rank's operands its own draws: (output, gradient) per case, and the
    bytes each case added to the group's stats."""
    out = {}
    for name in PRIM_DTYPES:
        dt = getattr(torch, name)
        for s in PRIM_SIZES:
            k = -(-s // M)
            tp = ModelShards(group, M, m)
            x = _draw(10 + m, (2, s, 3), dt).requires_grad_()
            y = reduce_scatter_to_model(x, tp, 1)
            (gx,) = torch.autograd.grad(y, x, _draw(20 + m, (2, k, 3), dt))
            out["reduce_scatter", name, s] = (y.detach(), gx,
                                              tp.stats["bytes"])
            tp = ModelShards(group, M, m)
            x = _draw(30, (2, s, 3), dt)
            mine = torch.cat([x, x.new_zeros((2, k * M - s, 3))], 1)[
                :, m * k:(m + 1) * k].clone().requires_grad_()
            y = gather_from_model(mine, tp, 1, s)
            (gx,) = torch.autograd.grad(y, mine, _draw(40 + m, (2, s, 3), dt))
            out["gather", name, s] = (y.detach(), gx, tp.stats["bytes"])
            tp = ModelShards(group, M, m)
            x = x.clone().requires_grad_()
            y = slice_to_model(x, tp, 1)
            (gx,) = torch.autograd.grad(y, x, _draw(50 + m, (2, k, 3), dt))
            out["slice", name, s] = (y.detach(), gx, tp.stats["bytes"])
    return out


def run_fsdp(ref_params, arch, axis, mesh, seq=FSDP_S):
    """One sharded fsdp step on this rank's groups: loss, norm, the whole
    updated parameters and first moments, and the model- and data-group
    bytes (the layers' and the step's ``stats``)."""
    d, m = coordinates(mesh)
    cfg = _axis_cfg(arch, axis)
    shards = ModelShards(model_group(mesh), M, m)
    data = DataShards(data_group(mesh), 2, d)
    bundle = build_model(cfg, device="cpu", shards=shards, data=data)
    whole = params_from_reference(ref_params[arch], cfg, "cpu")
    params = shard_params(whole, cfg, M, m, 2, d)
    opt = adamw.init(shard_params(whole, cfg, M, m, 2, d, moments=True))
    step = make_fsdp_train_step(bundle, FSDP_MICRO)
    new_p, new_o, met = step(params, opt, demo_batch(
        cfg, "train", FSDP_B, seq, seed=3), FSDP_WEIGHTS, LR)
    return {"loss": met["loss"], "gnorm": met["grad_norm"],
            "leaves": tree_leaves(unshard_params(new_p, cfg, shards, dp=data))
            + tree_leaves(unshard_params(new_o["m"], cfg, shards, dp=data)),
            "model": shards.stats["bytes"],
            "data": data.stats["bytes"] + step.stats["bytes"]}


def moe_calls(bundle, params, batch):
    """Each MoE chunk's (dispatch buffer, routed experts, kept choices) in
    one forward of ``bundle.loss_fn`` on ``batch``."""
    calls, route, dispatch = [], moe_mod.route, moe_mod.dispatch
    routes = []

    def spy_route(router, xt, cfg):
        r = route(router, xt, cfg)
        routes.append((r.idx.clone(), r.keep.clone()))
        return r

    def spy_dispatch(xt, r):
        xin = dispatch(xt, r)
        calls.append(xin.detach().clone())
        return xin

    moe_mod.route, moe_mod.dispatch = spy_route, spy_dispatch
    try:
        with torch.no_grad():
            bundle.loss_fn(params, batch)
    finally:
        moe_mod.route, moe_mod.dispatch = route, dispatch
    return [(x, i, k) for x, (i, k) in zip(calls, routes)]


def run_moe(ref_params, axis, mesh):
    """llama4-scout's MoE chunks in the forward of microbatch 0 (this data
    rank's row of it) on this rank's groups."""
    d, m = coordinates(mesh)
    arch = FSDP_ARCHS["moe"]
    cfg = _axis_cfg(arch, axis)
    shards = ModelShards(model_group(mesh), M, m)
    data = DataShards(data_group(mesh), 2, d)
    bundle = build_model(cfg, device="cpu", shards=shards, data=data)
    params = shard_params(params_from_reference(ref_params[arch], cfg, "cpu"),
                          cfg, M, m, 2, d)
    mb = FSDP_B // FSDP_MICRO
    rows = slice(d * mb // 2, (d + 1) * mb // 2)
    batch = {k: v[rows] for k, v in demo_batch(cfg, "train", FSDP_B, FSDP_S,
                                                seed=3).items()}
    return moe_calls(bundle, params, batch)


def run_usec(arch, axis, mesh):
    """One usec step at D 1 x M 2 (this rank's model pair, every worker on
    it) from the port's init: loss, norm, the whole updated parameters and
    first moments."""
    _, m = coordinates(mesh)
    cfg, pipe, plan, b_max = _cell(arch)
    cfg = dataclasses.replace(cfg, act_shard_axis=axis)
    shards = ModelShards(model_group(mesh), M, m)
    bundle = build_model(cfg, device="cpu", shards=shards)
    whole = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    params = shard_params(whole, cfg, M, m)
    step = make_usec_train_step(bundle, pipe.t_stage, b_max)
    new_p, new_o, _, met = step(params, adamw.init(params), None,
                                *_args(pipe, plan, b_max))
    return {"loss": met["loss"], "gnorm": met["grad_norm"],
            "leaves": tree_leaves(unshard_params(new_p, cfg, shards))
            + tree_leaves(unshard_params(new_o["m"], cfg, shards)),
            "model": shards.stats["bytes"]}


def _rank_job(rank, world, store, out_dir, ref_params):
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        mesh = make_worker_mesh(N, M)
        d, m = coordinates(mesh)
        res = {"coords": (d, m),
               "prims": run_primitives(model_group(mesh), m)}
        for axis in AXES:
            for kind, arch in FSDP_ARCHS.items():
                res["fsdp", kind, axis] = run_fsdp(ref_params, arch, axis,
                                                   mesh)
            res["fsdp", "uneven", axis] = run_fsdp(
                ref_params, FSDP_ARCHS["dense"], axis, mesh, UNEVEN_S)
            res["moe", axis] = run_moe(ref_params, axis, mesh)
            for arch in USEC_ARCHS:
                res["usec", arch, axis] = run_usec(arch, axis, mesh)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


_REFERENCE = r"""
import dataclasses, os, warnings
import numpy as np, jax, jax.numpy as jnp
import repro.configs as rc
from repro.configs.shapes import demo_batch
from repro.launch import sharding as shr
from repro.launch.mesh import make_worker_mesh
from repro.jax_compat import set_mesh
from repro.models import build_model
from repro.optim import adamw
from repro.runtime.trainstep import make_fsdp_train_step

warnings.simplefilter("ignore", DeprecationWarning)
OUT, LR, FSDP = {out!r}, {lr}, {fsdp!r}
B, S, MICRO, WEIGHTS = {b}, {s}, {micro}, {weights!r}
flat = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]
mesh = make_worker_mesh(2, 2)
key = jax.random.PRNGKey(0)
with set_mesh(mesh):
    for kind, arch in FSDP.items():
        cfg = dataclasses.replace(rc.get_config(arch).reduced(),
                                  param_dtype="float32",
                                  act_shard_axis="model",
                                  act_batch_axes=("data",))
        bundle = build_model(cfg)
        shapes = jax.eval_shape(bundle.init, key)
        pshard = shr.param_shardings(shapes, cfg, mesh)
        oshard = shr.opt_shardings(pshard, mesh, shapes)
        params = jax.device_put(bundle.init(key), pshard)
        opt = jax.device_put(adamw.init(params), oshard)
        step = make_fsdp_train_step(bundle, mesh, MICRO, grad_shardings=pshard)
        batch = {{k: jnp.asarray(v)
                 for k, v in demo_batch(cfg, "train", B, S, seed=3).items()}}
        new_p, new_o, m = step(params, opt, batch, jnp.asarray(WEIGHTS),
                               jnp.float32(LR))
        np.savez(os.path.join(OUT, f"fsdp_{{kind}}.npz"),
                 loss=np.asarray(m["loss"]), gnorm=np.asarray(m["grad_norm"]),
                 *(flat(new_p) + flat(new_o["m"])))
print("done")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess, the 4 ranks, and this process's
    one-process MoE forward and dry-runs, overlapped."""
    tmp = str(tmp_path_factory.mktemp("seq_parallel"))
    ref_dir = os.path.join(tmp, "ref")
    os.mkdir(ref_dir)
    code = _REFERENCE.format(out=ref_dir, lr=LR, fsdp=FSDP_ARCHS, b=FSDP_B,
                             s=FSDP_S, micro=FSDP_MICRO,
                             weights=FSDP_WEIGHTS.tolist())
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    ref = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True, env=env,
                           cwd=REPO)
    ref_params = {arch: _ref_params(arch) for arch in FSDP_ARCHS.values()}
    _spawn(_rank_job, 4, tmp, ref_params)
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(4)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        arch = FSDP_ARCHS["moe"]
        cfg = _axis_cfg(arch, "")
        one = build_model(cfg, device="cpu")
        mb = FSDP_B // FSDP_MICRO
        moe_one = moe_calls(one, params_from_reference(
            ref_params[arch], cfg, "cpu"), {
                k: v[:mb] for k, v in demo_batch(cfg, "train", FSDP_B, FSDP_S,
                                                 seed=3).items()})
        traces = {kind: dryrun.trace_fsdp(
            _axis_cfg(arch, "model"), MeshSpec((2, M), ("data", "model")),
            FSDP_MICRO, FSDP_B, FSDP_S, FSDP_WEIGHTS)
            for kind, arch in FSDP_ARCHS.items()}
    finally:
        torch.set_num_threads(threads)
    out, err = ref.communicate(timeout=560)
    assert ref.returncode == 0 and "done" in out, err[-3000:]
    return {"ranks": ranks, "ref_dir": ref_dir, "moe_one": moe_one,
            "traces": traces}


def _ref(runs, name):
    with np.load(os.path.join(runs["ref_dir"], f"{name}.npz")) as z:
        k = len(z.files) - 2
        return {"loss": z["loss"], "gnorm": z["gnorm"],
                "leaves": [z[f"arr_{i}"] for i in range(k)]}


# ---------------------------------------------------------------------- #
# The primitives
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("s", PRIM_SIZES)
@pytest.mark.parametrize("dtype", PRIM_DTYPES)
def test_reduce_scatter_to_model_forward_and_backward(dtype, s, runs):
    """Forward: this rank's ⌈S/M⌉ positions of the two ranks' sum, summed
    in fp32 and rounded once (the padded tail of the last slice zero).
    Backward: the two ranks' upstream gradients joined, trimmed to S. The
    stats count each collective's padded whole, as the dry-run does: the
    fp32 sum's and the backward gather's."""
    dt = getattr(torch, dtype)
    k = -(-s // M)
    total = sum(_draw(10 + m, (2, s, 3), dt).float() for m in range(M))
    total = torch.cat([total, total.new_zeros((2, k * M - s, 3))], 1).to(dt)
    grads = torch.cat([_draw(20 + m, (2, k, 3), dt) for m in range(M)], 1)
    for rank in runs["ranks"]:
        m = rank["coords"][1]
        y, gx, nbytes = rank["prims"]["reduce_scatter", dtype, s]
        assert y.dtype == dt and torch.equal(y, total[:, m * k:(m + 1) * k])
        assert torch.equal(gx, grads[:, :s])
        assert nbytes == 2 * k * M * 3 * (4 + dt.itemsize)


@pytest.mark.parametrize("s", PRIM_SIZES)
@pytest.mark.parametrize("dtype", PRIM_DTYPES)
def test_gather_and_slice_to_model_cut_unevenly(dtype, s, runs):
    """``gather_from_model(..., size=S)`` of the padded slices is the whole
    tensor, and its gradient this rank's padded slice of its own upstream
    gradient (zero past S); ``slice_to_model`` gives that slice, and its
    gradient is the ranks' gradients joined and trimmed to S."""
    dt = getattr(torch, dtype)
    k = -(-s // M)
    x = _draw(30, (2, s, 3), dt)
    pad = lambda t: torch.cat([t, t.new_zeros((2, k * M - s, 3))], 1)  # noqa
    grads = torch.cat([_draw(50 + m, (2, k, 3), dt) for m in range(M)], 1)
    for rank in runs["ranks"]:
        m = rank["coords"][1]
        mine = slice(m * k, (m + 1) * k)
        y, gx, nbytes = rank["prims"]["gather", dtype, s]
        assert torch.equal(y, x)
        assert torch.equal(gx, pad(_draw(40 + m, (2, s, 3), dt))[:, mine])
        assert nbytes == 2 * k * M * 3 * dt.itemsize
        y, gx, nbytes = rank["prims"]["slice", dtype, s]
        assert torch.equal(y, pad(x)[:, mine])
        assert torch.equal(gx, grads[:, :s])
        assert nbytes == 2 * k * M * 3 * dt.itemsize


def test_seq_cut_is_on_only_over_a_model_group():
    """The axis cuts only with ``"model"`` named and a group of more than
    one rank (the reference's constraint is the identity on one device);
    any other axis name is refused."""
    tp = ModelShards(None, 2, 0)
    on = _axis_cfg("qwen1.5-110b", "model")
    assert seq_cut(on, tp, 31) == (tp, 31)
    assert seq_cut(on, None, 31) is None
    assert seq_cut(on, ModelShards(None, 1, 0), 31) is None
    assert seq_cut(_axis_cfg("qwen1.5-110b", ""), tp, 31) is None
    with pytest.raises(ValueError):
        seq_cut(dataclasses.replace(on, act_shard_axis="data"), tp, 31)


# ---------------------------------------------------------------------- #
# The steps
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", list(FSDP_ARCHS) + ["uneven"])
def test_fsdp_step_with_the_axis_equals_the_step_without_it(kind, runs):
    """Every rank's loss, norm, gathered parameters and first moments with
    the axis within 1e-5 of the same ranks' step without it (the MoE
    router's moment within ROUTER_TOL); "uneven": reduced qwen1.5-110b at
    31 positions a row, so rank 1's slice carries a padded position. The
    loss is bitwise (the forward is); the leaves are not (see the module
    docstring)."""
    arch = FSDP_ARCHS.get(kind, FSDP_ARCHS["dense"])
    for rank in runs["ranks"]:
        got, want = rank["fsdp", kind, "model"], rank["fsdp", kind, ""]
        _held_fsdp(got, want, TOL, arch)
        assert torch.equal(got["loss"], want["loss"])
        assert got["model"] > want["model"] > 0


@pytest.mark.filterwarnings(
    "ignore:jax.nn.one_hot input should be integer-typed:DeprecationWarning")
@pytest.mark.parametrize("kind", list(FSDP_ARCHS))
def test_fsdp_step_with_the_axis_equals_the_reference(kind, runs):
    """Rank 0's fsdp step with the axis against the reference's GSPMD
    ``make_fsdp_train_step`` with ``act_shard_axis="model"``,
    ``act_batch_axes=("data",)`` on a (2, 2) mesh: 1e-4 (the router's
    moment at ROUTER_TOL)."""
    got = runs["ranks"][0]["fsdp", kind, "model"]
    _held_fsdp(got, _ref(runs, f"fsdp_{kind}"), REF_TOL, FSDP_ARCHS[kind])


def test_moe_buffers_are_this_ranks_experts_of_the_whole_sequence(runs):
    """Under the axis each rank's (E/M, C, D) dispatch buffers are the same
    ranks' without it bit for bit, and this rank's experts' slice of the
    one-process buffers within 1e-5; every chunk's routes (experts and
    kept choices) equal the one-process routes."""
    one = runs["moe_one"]
    assert one
    for rank in runs["ranks"]:
        m = rank["coords"][1]
        got, off = rank["moe", "model"], rank["moe", ""]
        assert len(got) == len(off) == len(one)
        for (x, idx, keep), (x0, idx0, keep0), (xw, idxw, keepw) in zip(
                got, off, one):
            n = xw.shape[0] // M
            assert x.shape == (n,) + xw.shape[1:]
            assert torch.equal(x, x0)
            assert torch.equal(idx, idx0) and torch.equal(keep, keep0)
            assert torch.equal(idx, idxw) and torch.equal(keep, keepw)
            assert _rel(x, xw[m * n:(m + 1) * n]) < TOL


@pytest.mark.parametrize("arch", USEC_ARCHS)
def test_usec_step_with_an_explicit_axis_equals_the_step_without_it(
        arch, runs):
    """The usec step at D 1 x M 2 with ``act_shard_axis="model"`` set on
    the config (as the reference's dry-run honours a cell's choice) within
    1e-5 of the same step without it; the two model pairs agree bitwise."""
    first = runs["ranks"][0]["usec", arch, "model"]
    for rank in runs["ranks"]:
        got, want = rank["usec", arch, "model"], rank["usec", arch, ""]
        _held(got, want, TOL)
        assert got["model"] > want["model"]
        assert all(torch.equal(a, b) for a, b in zip(got["leaves"],
                                                     first["leaves"]))


@pytest.mark.parametrize("kind", list(FSDP_ARCHS))
def test_collective_bytes_with_the_axis_equal_the_dry_run(kind, runs):
    """The dry-run's trace of the step with the axis on a fake 2 x 2 group:
    its model- and data-group bytes equal every gloo rank's ``stats``."""
    res = runs["traces"][kind]
    want = {g: res["cost"].groups[res["group_names"][g]]["bytes"]
            for g in ("model", "data")}
    for rank in runs["ranks"]:
        got = rank["fsdp", kind, "model"]
        assert {"model": got["model"], "data": got["data"]} == want


# ---------------------------------------------------------------------- #
# The bytes autograd keeps
# ---------------------------------------------------------------------- #
REMAT = {"save_outs": {"remat_save_outs": True},
         "block": {"remat_save_outs": False}}


def _forward_live(cfg, rows, seq):
    """The bytes alive at the end of one microbatch's forward (the loss and
    everything autograd keeps for the backward) of rank 0 on a fake 1 x 2
    group, on meta tensors."""
    with dryrun._Ranks(MeshSpec((1, M), ("data", "model"))) as ranks:
        bundle = build_model(cfg, device="meta", shards=ranks.shards)
        params = bundle.init(torch.Generator().manual_seed(0))
        for t in tree_leaves(params):
            t.requires_grad_()
        batch = {k: torch.zeros(shp, dtype=dryrun._torch_dtype(dt),
                                device="meta")
                 for k, (shp, dt) in batch_schema(cfg, "train", rows,
                                                  seq).items()}
        mem = MemoryTracker()
        with traced(mem):
            loss, _ = bundle.loss_fn(params, batch)
            live = mem.live
        del loss
    return live


@pytest.mark.parametrize("policy", list(REMAT))
def test_forward_keeps_one_mth_of_each_residual_boundary(policy):
    """Reduced qwen1.5-110b (bf16, D 64, 2 layers) on a fake 1 x 2 group,
    2 rows of 64 positions: the live bytes at the end of a microbatch's
    forward fall with the axis by exactly (M-1)/M of the residual
    boundaries the remat policy keeps. The reckoning: ``remat_save_outs``
    checkpoints each sublayer, and autograd keeps each checkpoint's input,
    the residual before each sublayer, 2 a layer; per block, each block's
    input, 1 a layer. Each is (rows, S, D) bf16 without the axis and
    (rows, S/M, D) with it. Everything else alive is the same: the
    sublayers' insides are recomputed, the gathered input of the final
    norm is whole either way, and the collectives keep nothing."""
    rows, seq = 2, 64
    live = {}
    for axis in AXES:
        cfg = dataclasses.replace(_axis_cfg("qwen1.5-110b", axis,
                                            reduced_fp32=False),
                                  **REMAT[policy])
        live[axis] = _forward_live(cfg, rows, seq)
    boundaries = cfg.n_layers * (2 if policy == "save_outs" else 1)
    residual = rows * seq * cfg.d_model * 2
    assert live[""] - live["model"] == boundaries * residual * (M - 1) // M
