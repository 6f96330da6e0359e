"""Model shards: each tensor-parallel layer and the usec step over a
``("data", "model")`` mesh of gloo ranks on the CPU, against the one-shard
port and against the JAX package's GSPMD step.

Layers (fp32; M = 2 and M = 4, each rank holding its cut by the sharding
rules): attention with its query heads aligned to the shards (its own K/V
heads, or K/V split through a head and gathered: H 8, Hk 2 over 4), with
query heads split across a head (H 6 over 4; q, k, v gathered), windowed
and biased; the MLP (swiglu, squared_relu); the vocabulary-parallel
embedding and cross entropy (untied and tied); the MoE (experts over the
shards, with capacity drops and a chunked stream); the RG-LRU and SSD
blocks. Each rank's output and its gradients (inputs and its slice of
every parameter) against the one-shard function's within 1e-5 of the
largest value (the same fp32 ops summed in another order).

The usec step at 2 x 2 (D = 2 data indices of N = 2 workers, M = 2 model
shards; a dense, an MoE and an rglru reduced config in fp32, worker 1's
tiles computed twice and counted once): against the port's one-process
step within 1e-5, and against the reference's ``make_usec_train_step(mesh
(2, 2), grad_shardings=pshard)`` on 4 forced host devices within 1e-4 (an
updated parameter where its gradient is above AdamW's eps scale, as
``tests/test_torch_distributed.py`` holds it); compressed over two
chained steps, the parameters, moments, scales and each model shard's
``ef`` within the quantizer's rounding-tie rule. The trainer under
``--model-shards`` checkpoints at 2 x 2 and resumes at 1 x 4 and 1 x 1
with the uninterrupted run's losses and gradient norms.

The ranks are spawned processes meeting in a file store under the test's
temporary directory, one thread each; the reference runs in one
subprocess, overlapped with them.
"""

import contextlib
import dataclasses
import io
import json
import os
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
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    MeshSpec,
    coordinates,
    data_group,
    make_worker_mesh,
    model_group,
)
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import build_model, params_from_reference  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import rglru as rglru_mod  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models.layers import init_mlp, mlp_parts  # noqa: E402
from repro_torch.models.losses import lm_loss  # noqa: E402
from repro_torch.models.parallel import (  # noqa: E402
    ModelShards,
    finish,
    over,
    shard_params,
    unshard_params,
)
from repro_torch.models.transformer import (  # noqa: E402
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import compression  # noqa: E402
from repro_torch.runtime.executor import block_plan  # noqa: E402
from repro_torch.runtime.trainstep import make_usec_train_step  # noqa: E402

TOL = 1e-5
REF_TOL = 1e-4
B, S = 2, 40
# The step cell: N = 2 workers, cyclic J = 2 over 4 tiles of one 32-token
# sample, S = 1, no worker dropped (every tile computed twice, once
# counted); a 2 x 2 mesh.
N, G, J, SEQ, LR = 2, 4, 2, 32, 1e-3
D_MESH, M_MESH = 2, 2
ARCHS = {"dense": "glm4-9b", "moe": "deepseek-moe-16b",
         "recurrent": "recurrentgemma-2b"}
COMP_STEPS = (0, 1)  # the data step of each chained compressed step
TRAIN_ARGS = ["--arch", "glm4-9b", "--reduced", "--workers", "2",
              "--seq-len", "32", "--tile-samples", "1",
              "--straggler-tolerance", "1", "--drop-stragglers", "1",
              "--log-every", "1", "--device", "cpu"]


def _rel(got, want) -> float:
    got = np.asarray(torch.as_tensor(got).detach().double())
    want = np.asarray(torch.as_tensor(want).detach().double())
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else float(
        np.abs(got).max())


# ---------------------------------------------------------------------- #
# Layer cases
# ---------------------------------------------------------------------- #
def _cfg(arch, **kw):
    return dataclasses.replace(get_config(arch).reduced(),
                               param_dtype="float32", **kw)


def _randomize(tree, gen):
    """Every leaf drawn anew (biases and gates included), so a wrong slice
    shows."""
    return tree_map(lambda t: torch.randn(t.shape, generator=gen) * 0.3,
                    tree)


def _attention(cfg, window=None):
    def make(gen):
        return _randomize(attn_mod.init_attention(gen, cfg), gen)

    def run(p, x, tp):
        pos = torch.arange(x.shape[1])
        return finish(attn_mod.attention_parts(p, x, cfg, pos, window=window,
                                               tp=tp), tp)

    return cfg, ("stack", "blocks", 0, "temporal"), make, run


def _mlp(cfg):
    def make(gen):
        return init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, torch.float32)

    def run(p, x, tp):
        return finish(mlp_parts(p, x, cfg.act, over(tp, p["w_up"].shape[-1],
                                                    cfg.d_ff)), tp)

    return cfg, ("stack", "blocks", 0, "ffn"), make, run


def _moe(cfg):
    def make(gen):
        return moe_mod.init_moe(gen, cfg)

    def run(p, x, tp):
        parts, aux = moe_mod.moe_parts(p, x, cfg, tp)
        return finish(parts, tp) + 3.0 * aux

    return cfg, ("stack", "blocks", 0, "ffn"), make, run


def _recurrent(cfg, mod, init, parts):
    def make(gen):
        return _randomize(init(gen, cfg), gen) if mod is ssm_mod else \
            init(gen, cfg)

    def run(p, x, tp):
        return finish(parts(p, x, cfg, tp), tp)

    return cfg, ("stack", "blocks", 0, "temporal"), make, run


def _embed_loss(cfg):
    """The embedding of tokens plus the input, then the LM loss: both the
    lookup and the cross entropy vocabulary-parallel."""
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(7))

    def make(gen):
        p = build_model(cfg, device="cpu").init(gen)
        return {k: p[k] for k in ("embed", "unembed") if k in p}

    def run(p, x, tp):
        bundle = build_model(cfg, device="cpu", shards=tp)
        h = bundle.embed_batch(p, {"tokens": tokens})[0] + x
        unembed = p["embed"].T if cfg.tie_embeddings else p["unembed"]
        nll, _ = lm_loss(h, unembed, tokens, chunk=16,
                         tp=over(tp, unembed.shape[-1], cfg.vocab_size))
        return nll

    return cfg, (), make, run


def layer_cases():
    return {
        "attn_aligned": _attention(_cfg("glm4-9b", d_model=32, n_heads=4,
                                        n_kv_heads=2, head_dim=16,
                                        attn_chunk=16)),
        "attn_split_kv": _attention(_cfg("glm4-9b", d_model=64, n_heads=8,
                                         n_kv_heads=2, head_dim=16)),
        "attn_unaligned": _attention(_cfg("glm4-9b", d_model=48, n_heads=6,
                                          n_kv_heads=2, head_dim=16,
                                          qkv_bias=True, attn_chunk=16)),
        "attn_window": _attention(_cfg("recurrentgemma-2b", d_model=48,
                                       n_heads=6, n_kv_heads=1, head_dim=16,
                                       attn_chunk=16), window=8),
        "mlp_swiglu": _mlp(_cfg("glm4-9b", d_ff=64)),
        "mlp_squared_relu": _mlp(_cfg("nemotron-4-15b", d_ff=64)),
        "embed_ce": _embed_loss(_cfg("glm4-9b")),
        "embed_ce_tied": _embed_loss(_cfg("recurrentgemma-2b")),
        "moe": _moe(_cfg("deepseek-moe-16b", capacity_factor=0.6,
                         moe_chunk=32)),
        "rglru": _recurrent(_cfg("recurrentgemma-2b"), rglru_mod,
                            rglru_mod.init_rglru, rglru_mod.rglru_parts),
        "ssm": _recurrent(_cfg("mamba2-370m", train_mode="usec"), ssm_mod,
                          ssm_mod.init_ssm, ssm_mod.ssm_parts),
    }


def cut(tree, prefix, cfg, n, rank):
    """Shard ``rank`` of ``n`` of a layer's tree by the rules' ``"model"``
    dims, the leaves keyed as they sit in the model's tree."""
    mesh = MeshSpec((1, n), ("data", "model"))

    def one(path, t):
        spec = sharding.spec_for_param(sharding.keystr(prefix + path),
                                       tuple(t.shape), cfg, mesh)
        d = sharding.model_dim(spec)
        if d is None or n == 1:
            return t
        k = t.shape[d] // n
        return t.narrow(d, rank * k, k).contiguous()

    return sharding.map_with_path(one, tree)


def run_layer(name, case, tp):
    """(output, [d input] + d of each of this rank's leaves, routing keep
    of the MoE's first chunk or None)."""
    cfg, prefix, make, run = case
    gen = torch.Generator().manual_seed(sum(map(ord, name)))
    full = make(gen)
    x = torch.randn((B, S, cfg.d_model), generator=gen)
    n, r = (1, 0) if tp is None else (tp.size, tp.rank)
    local = cut(full, prefix, cfg, n, r)
    leaves = [t.detach().clone().requires_grad_() for t in tree_leaves(local)]
    xg = x.clone().requires_grad_()
    out = run(tree_unflatten(local, leaves), xg, tp)
    g = torch.randn(out.shape, generator=gen)
    grads = torch.autograd.grad((out * g).sum(), [xg] + leaves,
                                allow_unused=True)
    grads = [torch.zeros_like(t) if d is None else d
             for d, t in zip(grads, [xg] + leaves)]
    keep = None
    if name == "moe":
        keep = moe_mod.route(full["router"], x.reshape(-1, cfg.d_model)[:32],
                             cfg).keep
    return out.detach(), grads, keep


def one_shard_layers():
    return {name: run_layer(name, case, None)
            for name, case in layer_cases().items()}


# ---------------------------------------------------------------------- #
# The step cell
# ---------------------------------------------------------------------- #
def _cell(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="float32",
                              grad_accum_dtype="float32")
    p = cyclic_placement(N, G, J)
    pipe = TokenPipeline(cfg, p, seq_len=SEQ, tile_samples=1, seed=0)
    plan = compile_plan(p, solve_assignment(p, np.ones(N), stragglers=1),
                        rows_per_tile=1, stragglers=1)
    return cfg, pipe, plan, int(plan.n_valid.max()) + 1


def _args(pipe, plan, b_max, step=0):
    sb = pipe.staged_for_step(step)
    bp = block_plan(plan, sb.slot_of, 1, stragglers=(), b_max=b_max)
    return (sb.arrays, bp.blk_slot, bp.blk_include, bp.n_blocks[:, None],
            torch.tensor(LR))


def run_steps(ref_params, mesh=None):
    """Every step cell on this process (all N workers, whole weights) or
    over ``mesh`` (this rank's workers and shard); leaves gathered whole
    (the error feedback: this rank's slices)."""
    out = {}
    shards = None
    if mesh is not None:
        _, m = coordinates(mesh)
        shards = ModelShards(model_group(mesh), M_MESH, m)
    n_local = N if mesh is None else N // D_MESH
    for kind, arch in ARCHS.items():
        cfg, pipe, plan, b_max = _cell(arch)
        bundle = build_model(cfg, device="cpu", shards=shards)
        params = params_from_reference(ref_params[arch], cfg, "cpu", shards)

        def whole(tree):
            return unshard_params(tree, cfg, shards) if shards else tree

        group = None if mesh is None else data_group(mesh)
        step = make_usec_train_step(bundle, pipe.t_stage, b_max, group=group)
        new_p, new_o, _, m = step(params, adamw.init(params), None,
                                  *_args(pipe, plan, b_max))
        out[kind] = {"loss": m["loss"], "gnorm": m["grad_norm"],
                     "leaves": tree_leaves(whole(new_p))
                     + tree_leaves(whole(new_o["m"]))}
        comp_step = make_usec_train_step(bundle, pipe.t_stage, b_max,
                                         compress_grads=True, group=group)
        p, o = params, adamw.init(params)
        comp = compression.init_state(p, n_local)
        for s, data in enumerate(COMP_STEPS):
            p, o, comp, m = comp_step(p, o, comp,
                                      *_args(pipe, plan, b_max, data))
            out[f"{kind}_comp{s}"] = {
                "loss": m["loss"], "gnorm": m["grad_norm"],
                "leaves": tree_leaves(whole(p)) + tree_leaves(whole(o["m"])),
                "ef": tree_leaves(comp["ef"]),
                "scale": tree_leaves(comp["scale"])}
    if shards is not None:
        out["tp_stats"] = dict(shards.stats)
    return out


# ---------------------------------------------------------------------- #
# The ranks
# ---------------------------------------------------------------------- #
_FP32 = "repro_torch fp32 configs"


def _fp32_configs():
    real = port_configs.get_config
    port_configs.get_config = lambda name: dataclasses.replace(
        real(name), param_dtype="float32")
    return real


def _trainer(argv) -> str:
    real = _fp32_configs()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            port_train.main(TRAIN_ARGS + list(argv))
    finally:
        port_configs.get_config = real
    return buf.getvalue()


def _rank_job(rank, world, store, out_dir, ref_params, ckpt):
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        pair = torch.distributed.new_group([0, 1])
        res = {"layers": {}}
        for n, group in ((4, None), (2, pair)):
            if rank >= n:
                continue
            tp = ModelShards(group, n, rank)
            res["layers"][n] = {name: run_layer(name, case, tp)
                                for name, case in layer_cases().items()}
        mesh = make_worker_mesh(N, M_MESH)
        res["coords"] = coordinates(mesh)
        res["steps"] = run_steps(ref_params, mesh)
        # The trainer: 4 steps at 2 x 2 (checkpoints after steps 2 and 4),
        # then step 2's checkpoint resumed at 1 x 4.
        res["train22"] = _trainer(["--model-shards", "2", "--steps", "4",
                                   "--ckpt-dir", ckpt, "--ckpt-every", "2"])
        torch.distributed.barrier()
        resumed = os.path.join(out_dir, "resumed14")
        if rank == 0:
            shutil.copytree(ckpt, resumed)
            with open(os.path.join(resumed, "LATEST"), "w") as fh:
                fh.write("step_000000002")
        torch.distributed.barrier()
        res["train14"] = _trainer(["--model-shards", "4", "--steps", "4",
                                   "--resume", "--ckpt-dir", resumed])
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _one_rank_job(rank, world, store, out_dir, ckpt):
    """Step 2's checkpoint resumed by the trainer on one gloo rank."""
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        out = _trainer(["--steps", "4", "--resume", "--ckpt-dir", ckpt])
        with open(os.path.join(out_dir, "train11.txt"), "w") as fh:
            fh.write(out)
    finally:
        torch.distributed.destroy_process_group()


_REFERENCE = r"""
import dataclasses, os
import numpy as np, jax, jax.numpy as jnp
import repro.configs as rc
from repro.core import cyclic_placement, solve_assignment, compile_plan
from repro.data import TokenPipeline
from repro.launch import sharding as shr
from repro.launch.mesh import make_worker_mesh
from repro.jax_compat import set_mesh
from repro.models import build_model
from repro.optim import adamw
from repro.runtime import compression
from repro.runtime.executor import block_plan
from repro.runtime.trainstep import make_usec_train_step

OUT = {out!r}
N, G, J, SEQ, LR = {n}, {g}, {j}, {seq}, {lr}
ARCHS, COMP_STEPS = {archs!r}, {comp_steps!r}
flat = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]
mesh = make_worker_mesh(N, {m})

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
        key = jax.random.PRNGKey(0)
        pshard = shr.param_shardings(jax.eval_shape(bundle.init, key), cfg,
                                     mesh)
        place = lambda: jax.device_put(bundle.init(key), pshard)
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

        step = make_usec_train_step(bundle, mesh, pipe.t_stage, b_max,
                                    grad_shardings=pshard)
        params = place()
        new_p, new_o, _, m = step(params, adamw.init(params), None, *args(0))
        save(kind, m, new_p, new_o)
        step = make_usec_train_step(bundle, mesh, pipe.t_stage, b_max,
                                    compress_grads=True, grad_shardings=pshard)
        pr = place()
        op, cs = adamw.init(pr), compression.init_state(pr)
        for s, data in enumerate(COMP_STEPS):
            pr, op, cs, m = step(pr, op, cs, *args(data))
            save(f"{{kind}}_comp{{s}}", m, pr, op,
                 flat(cs["ef"]) + flat(cs["scale"]))
print("done")
"""


def _ref_params(arch):
    import jax

    import repro.configs as rc
    from repro.models import build_model as ref_build_model

    cfg = dataclasses.replace(rc.get_config(arch).reduced(),
                              param_dtype="float32")
    return jax.tree.map(np.asarray,
                        ref_build_model(cfg).init(jax.random.PRNGKey(0)))


def _spawn(job, world, tmp, *args):
    store = os.path.join(tmp, f"store_{job.__name__}")
    torch.multiprocessing.start_processes(
        job, args=(world, store, tmp) + args, nprocs=world,
        start_method="spawn")


def _report(out: str, r: int, world: int) -> dict:
    line = next(ln for ln in out.splitlines()
                if ln.startswith(f"rank {r} of {world}: "))
    return json.loads(line.split(": ", 1)[1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess, the 4 ranks (layers at M = 4 and 2, the
    2 x 2 steps, the trainer), the one-rank resume, and this process's
    one-shard layers and steps, overlapped."""
    tmp = str(tmp_path_factory.mktemp("tp"))
    ref_dir = os.path.join(tmp, "ref")
    os.mkdir(ref_dir)
    code = _REFERENCE.format(out=ref_dir, n=N, g=G, j=J, seq=SEQ, lr=LR,
                             archs=ARCHS, comp_steps=COMP_STEPS, m=M_MESH)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    ref = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True, env=env,
                           cwd=REPO)
    ref_params = {arch: _ref_params(arch) for arch in ARCHS.values()}
    ckpt = os.path.join(tmp, "ckpt22")
    _spawn(_rank_job, 4, tmp, ref_params, ckpt)
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(4)]
    resumed = os.path.join(tmp, "resumed11")
    shutil.copytree(ckpt, resumed)
    with open(os.path.join(resumed, "LATEST"), "w") as fh:
        fh.write("step_000000002")
    _spawn(_one_rank_job, 1, tmp, resumed)
    with open(os.path.join(tmp, "train11.txt")) as fh:
        train11 = fh.read()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = {"layers": one_shard_layers(), "steps": run_steps(ref_params)}
    finally:
        torch.set_num_threads(threads)
    out, err = ref.communicate(timeout=560)
    assert ref.returncode == 0 and "done" in out, err[-3000:]
    return {"ranks": ranks, "one": one, "ref_dir": ref_dir,
            "ref_params": ref_params, "train11": train11}


# ---------------------------------------------------------------------- #
# Layers
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", sorted(layer_cases()))
def test_layer_equals_the_one_shard_layer(name, n, runs):
    """Every rank's output equals the one-shard output and its gradients
    the one-shard gradients (the input's whole, each parameter's this
    rank's slice), within 1e-5; the MoE's routing (capacity drops
    included) equal."""
    cfg, prefix, _, _ = layer_cases()[name]
    want_out, want_grads, want_keep = runs["one"]["layers"][name]
    whole = tree_unflatten(cut_like(name), want_grads[1:])
    for r in range(n):
        out, grads, keep = runs["ranks"][r]["layers"][n][name]
        assert _rel(out, want_out) < TOL
        assert _rel(grads[0], want_grads[0]) < TOL
        mine = tree_leaves(cut(whole, prefix, cfg, n, r))
        assert len(mine) == len(grads) - 1
        for got, want in zip(grads[1:], mine):
            assert got.shape == want.shape
            assert _rel(got, want) < TOL
        if keep is not None:
            assert torch.equal(keep, want_keep) and not keep.all()


def cut_like(name):
    """The layer's whole parameter tree (its structure)."""
    cfg, _, make, _ = layer_cases()[name]
    return make(torch.Generator().manual_seed(0))


def test_some_layer_leaves_were_cut_at_both_shard_counts(runs):
    """Each case cuts at least one leaf over 2 and over 4 shards, and the
    non-aligned and split-K/V attention cases take their routes."""
    for name, (cfg, prefix, _, _) in layer_cases().items():
        full = cut_like(name)
        for n in (2, 4):
            local = cut(full, prefix, cfg, n, 0)
            assert any(a.shape != b.shape for a, b in zip(
                tree_leaves(local), tree_leaves(full))), (name, n)
    unaligned = layer_cases()["attn_unaligned"][0]
    assert unaligned.n_heads % 4 and (unaligned.n_heads * 16) % 4 == 0
    split_kv = layer_cases()["attn_split_kv"][0]
    assert split_kv.n_kv_heads % 4 and (split_kv.n_kv_heads * 16) % 4 == 0


# ---------------------------------------------------------------------- #
# The usec step at 2 x 2
# ---------------------------------------------------------------------- #
def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _held(got, want, tol, lr=LR):
    """Loss and norm within ``tol``; each leaf within ``tol`` of its
    largest value where the update's gradient is live (a first moment
    above 1e-7), and every element within 2 x ``lr`` (AdamW's first update
    g / (|g| + eps) near g = 0)."""
    assert _rel(got["loss"], want["loss"]) < tol
    assert _rel(got["gnorm"], want["gnorm"]) < tol
    n = len(want["leaves"]) // 2
    assert len(got["leaves"]) == 2 * n
    for i, (g, w) in enumerate(zip(got["leaves"], want["leaves"])):
        g, w = np.asarray(torch.as_tensor(g)), np.asarray(torch.as_tensor(w))
        if i >= n:
            assert _rel(g, w) < tol
            continue
        live = np.abs(np.asarray(torch.as_tensor(want["leaves"][n + i]))) \
            >= 1e-7
        err = np.abs(g - w)
        assert (err[live] <= tol * np.abs(w).max()).all()
        assert (err <= 2 * lr).all()


def _ties(off) -> bool:
    """At most 0.1 % of a leaf's elements (one, in a leaf of fewer than
    1000) off: the ones an int8 rounding tie sent the other way."""
    return int(off.sum()) <= max(1, off.size // 1000)


def _quantized(got, want, tol):
    """The compressed rule: the elements of a leaf off by more than ``tol``
    of its top are at most the rounding ties of :func:`_ties`, each within
    2e-2 of the top (a flipped int8 quantum)."""
    assert _rel(got["loss"], want["loss"]) < tol
    assert _rel(got["gnorm"], want["gnorm"]) < tol
    for i, (g, w) in enumerate(zip(got["leaves"], want["leaves"])):
        g, w = np.asarray(torch.as_tensor(g)), np.asarray(torch.as_tensor(w))
        off = np.abs(g - w) > tol * np.abs(w).max()
        assert _ties(off) and _rel(g, w) < 2e-2, (
            i, w.shape, int(off.sum()), _rel(g, w), np.abs(g - w).max(),
            np.abs(w).max())


def _ref(runs, name):
    z = _npz(os.path.join(runs["ref_dir"], f"{name}.npz"))
    n = len(z) - 2
    return {"loss": z["loss"], "gnorm": z["gnorm"],
            "leaves": [z[f"arr_{i}"] for i in range(n)]}


@pytest.mark.parametrize("kind", list(ARCHS))
def test_two_by_two_equals_the_one_process_step(kind, runs):
    """fp32: every rank's loss, gradient norm (replicated leaves counted
    once), gathered parameters and first moments equal the one-process
    step's within 1e-5; the two model shards of a data index agree
    bitwise, as do the two data indices."""
    want = runs["one"]["steps"][kind]
    for rank in runs["ranks"]:
        _held(rank["steps"][kind], want, TOL)
        for a, b in zip(rank["steps"][kind]["leaves"],
                        runs["ranks"][0]["steps"][kind]["leaves"]):
            assert torch.equal(a, b)


@pytest.mark.filterwarnings(
    "ignore:jax.nn.one_hot input should be integer-typed:DeprecationWarning")
@pytest.mark.parametrize("kind", list(ARCHS))
def test_two_by_two_equals_the_reference_gspmd_step(kind, runs):
    """fp32: rank 0's step against the reference's on a (2, 2) mesh with
    ``grad_shardings=pshard``, within 1e-4."""
    ref = _ref(runs, kind)
    ref["leaves"] = ref["leaves"][:len(runs["ranks"][0]["steps"][kind]
                                       ["leaves"])]
    _held(runs["ranks"][0]["steps"][kind], ref, REF_TOL)


def _ef_slices(whole_ef, cfg, m):
    """Model shard ``m`` of 2 of one worker's error feedback leaves."""
    like = build_model(cfg, device="meta").init(torch.Generator())
    tree = tree_unflatten(like, [torch.as_tensor(e) for e in whole_ef])
    return tree_leaves(shard_params(tree, cfg, M_MESH, m))


@pytest.mark.filterwarnings(
    "ignore:jax.nn.one_hot input should be integer-typed:DeprecationWarning")
@pytest.mark.parametrize("s", range(len(COMP_STEPS)))
@pytest.mark.parametrize("kind", list(ARCHS))
def test_compressed_two_by_two_equals_the_reference_and_one_process(
        kind, s, runs):
    """int8 + error feedback over two chained steps at 2 x 2: parameters,
    first moments, the scales (a MAX over data x model: the whole leaf's)
    against the reference's and the one-process step's; each rank's
    ``ef`` rows are its workers' slices (rank (0, m): worker 0's, which is
    the reference's host copy, and the one-process step's row 0)."""
    name = f"{kind}_comp{s}"
    cfg = _cell(ARCHS[kind])[0]
    one = runs["one"]["steps"][name]
    ref = _ref(runs, name)
    n = len(one["leaves"])
    n_ef = len(one["ef"])
    ref_ef = ref["leaves"][n:n + n_ef]
    ref_scale = ref["leaves"][n + n_ef:]
    ref["leaves"] = ref["leaves"][:n]
    for r, rank in enumerate(runs["ranks"]):
        got = rank["steps"][name]
        _quantized(got, ref, REF_TOL)
        _quantized(got, one, TOL)
        for a, b, c in zip(got["scale"], ref_scale, one["scale"]):
            assert _rel(a, b) < REF_TOL and _rel(a, c) < TOL
        d, m = rank["coords"]
        mine = _ef_slices([e[d] for e in one["ef"]], cfg, m)
        theirs = _ef_slices(ref_ef, cfg, m) if d == 0 else None
        for i, e in enumerate(got["ef"]):
            assert e.shape[0] == 1 and e[0].shape == mine[i].shape
            off = np.abs(e[0].numpy() - mine[i].numpy()) > \
                TOL * 127 * float(one["scale"][i])
            assert _ties(off)
            if theirs is not None:
                off = np.abs(e[0].numpy() - theirs[i].numpy()) > \
                    REF_TOL * 127 * float(ref_scale[i])
                assert _ties(off)


def test_mesh_coordinates_and_tp_traffic(runs):
    """Rank r is (r // 2, r % 2) on the 2 x 2 mesh, and every rank's model
    group carried the steps' collectives (the same count on each)."""
    stats = [rank["steps"]["tp_stats"] for rank in runs["ranks"]]
    assert [tuple(rank["coords"]) for rank in runs["ranks"]] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert len({s["collectives"] for s in stats}) == 1
    assert all(s["bytes"] > 0 for s in stats)


# ---------------------------------------------------------------------- #
# The trainer, its checkpoint across layouts
# ---------------------------------------------------------------------- #
def test_checkpoint_at_two_by_two_resumes_at_one_by_four_and_one(runs):
    """``main --model-shards 2`` on 4 ranks for 4 steps (a checkpoint, whole
    leaves, after step 2); step 2's checkpoint resumed by ``--model-shards
    4`` on the same 4 ranks and by one rank: steps 2 and 3 have the same
    losses and gradient norms (1e-5), every rank reports its model
    index."""
    out22 = runs["ranks"][0]["train22"]
    out14 = runs["ranks"][0]["train14"]
    full = _report(out22, 0, 4)
    assert [_report(out22, r, 4)["model_index"] for r in range(4)] == [
        0, 1, 0, 1]
    assert [_report(out22, r, 4)["workers"] for r in range(4)] == [
        [0], [0], [1], [1]]
    assert "at step 2" in out14 and "at step 2" in runs["train11"]
    for out, world in ((out14, 4), (runs["train11"], 1)):
        rep = _report(out, 0, world)
        assert _rel(rep["losses"], full["losses"][2:]) < TOL
        assert _rel(rep["grad_norms"], full["grad_norms"][2:]) < TOL
    assert _report(out14, 3, 4)["model_index"] == 3
    assert full["tp_bytes"] > 0 and _report(runs["train11"], 0, 1)[
        "tp_bytes"] == 0
    for r in range(1, 4):
        assert runs["ranks"][r]["train22"] == ""
