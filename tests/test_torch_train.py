"""The port's training path against the JAX package's, on the CPU.

Same numpy-seeded inputs and the same weights (the reference's init carried
across with ``params_from_reference``) go through ``repro.*`` and
``repro_torch.*``: the chunked cross entropy and the LM loss (values and
gradients against ``jax.value_and_grad``), AdamW and ``warmup_cosine``,
int8 gradient compression with error feedback over 3 steps, the staged
``TokenPipeline`` arrays (bitwise), ``loss_fn`` and its gradients for six
reduced archs, the usec train step (with and without a dropped worker, and
with compression over two steps), the usec step against the fsdp step for
one worker, ``launch.train.main`` against the reference's trainer, and a
reference train checkpoint resumed by the port. The multi-worker reference
runs once, in one subprocess with 4 forced host devices.

Tolerances: fp32 throughout; 1e-4 of the reference's largest value for a
loss, a gradient leaf or an updated parameter leaf (the same fp32 ops
summed in another order, through a whole model); 1e-6 for AdamW and the
schedule (one elementwise chain); the pipeline arrays and the compression's
int8 sums bitwise.
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from conftest import run_with_devices  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.core import cyclic_placement as ref_cyclic  # noqa: E402
from repro.data import TokenPipeline as RefPipeline  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import losses as ref_losses  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim import warmup_cosine as ref_warmup_cosine  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch import models as port_models  # noqa: E402
from repro_torch.configs import demo_batch, get_config  # noqa: E402
from repro_torch.core import (  # noqa: E402
    compile_plan,
    cyclic_placement,
    solve_assignment,
)
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import build_model, params_from_reference  # noqa: E402
from repro_torch.models import losses  # noqa: E402
from repro_torch.models.attention import (  # noqa: E402
    FlashAttentionFn,
    chunked_attention,
)
from repro_torch.models.transformer import tree_leaves  # noqa: E402
from repro_torch.optim import adamw, warmup_cosine  # noqa: E402
from repro_torch.runtime import compression  # noqa: E402
from repro_torch.runtime.executor import block_plan  # noqa: E402
from repro_torch.runtime.trainstep import (  # noqa: E402
    make_fsdp_train_step,
    make_usec_train_step,
)

TOL = 1e-4
LOSS_ARCHS = ["stablelm-1.6b", "internvl2-2b", "hubert-xlarge",
              "deepseek-moe-16b", "mamba2-370m", "recurrentgemma-2b"]
REF_MOE_WARNING = pytest.mark.filterwarnings(
    "ignore:jax.nn.one_hot input should be integer-typed:DeprecationWarning")
# The usec-step cell: reduced stablelm-1.6b in fp32, N = 4 workers, cyclic
# J = 2 over 8 tiles of one 32-token sample, S = 1; gradients accumulated per
# worker in fp32 (1e-4), or in bf16 as stablelm-1.6b's config asks (each
# worker's sum rounds to bf16 where the two packages' fp32 gradients may
# straddle a rounding boundary: 1e-2 of a leaf's largest value, ~2.5 bf16
# ulps).
N, G, J, SEQ = 4, 8, 2, 32
STEP_LR = 1e-3
TRAIN_ARGS = ["--arch", "stablelm-1.6b", "--reduced", "--workers", "4",
              "--seq-len", "32", "--tile-samples", "1",
              "--straggler-tolerance", "1", "--drop-stragglers", "1",
              "--log-every", "0"]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else float(
        np.abs(got).max())


def _fp32(arch):
    return (dataclasses.replace(get_config(arch).reduced(),
                                param_dtype="float32"),
            dataclasses.replace(ref_configs.get_config(arch).reduced(),
                                param_dtype="float32"))


@functools.lru_cache(maxsize=None)
def _ref_params(arch, seed=0):
    _, ref_cfg = _fp32(arch)
    return jax.tree.map(np.asarray,
                        ref_build_model(ref_cfg).init(jax.random.PRNGKey(seed)))


# ---------------------------------------------------------------------- #
# The reference's multi-worker runs (one subprocess, 4 host devices)
# ---------------------------------------------------------------------- #
_REFERENCE = r"""
import dataclasses, json, os, shutil
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
import repro.configs as rc
from repro.core import cyclic_placement, solve_assignment, compile_plan
from repro.data import TokenPipeline
from repro.models import build_model
from repro.optim import adamw
from repro.runtime import compression
from repro.runtime.executor import block_plan
from repro.runtime.trainstep import make_usec_train_step
from repro.launch.mesh import make_worker_mesh
from repro.jax_compat import make_mesh, set_mesh, shard_map

OUT = {out!r}
N, G, J, SEQ, LR = {n}, {g}, {j}, {seq}, {lr}
real = rc.get_config
rc.get_config = lambda name: dataclasses.replace(real(name), param_dtype="float32")
cfg = rc.get_config("stablelm-1.6b").reduced()
params = build_model(cfg).init(jax.random.PRNGKey(0))
copy = lambda t: jax.tree.map(jnp.array, t)
flat = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]
p = cyclic_placement(N, G, J)
pipe = TokenPipeline(cfg, p, seq_len=SEQ, tile_samples=1, seed=0)
plan = compile_plan(p, solve_assignment(p, np.ones(N), stragglers=1),
                    rows_per_tile=1, stragglers=1)
b_max = int(plan.n_valid.max()) + 1
mesh = make_worker_mesh(N, 1)
res = {{}}
# (tag, grad_accum_dtype, compress, [(dropped, data step)]): compressed
# steps chain, the others start from the init.
CELLS = [("fp32", "float32", False, [((), 0), ((1,), 0)]),
         ("bf16", "bfloat16", False, [((), 0)]),
         ("comp", "float32", True, [((), 0), ((), 1)])]
with set_mesh(mesh):
    opt = adamw.init(params)
    for tag, acc, comp, cases in CELLS:
        bundle = build_model(dataclasses.replace(cfg, grad_accum_dtype=acc))
        step = make_usec_train_step(bundle, mesh, pipe.t_stage, b_max,
                                    compress_grads=comp)
        pr, op = copy(params), copy(opt)
        cs = compression.init_state(params) if comp else None
        for bad, s in cases:
            sb = pipe.staged_for_step(s)
            bp = block_plan(plan, sb.slot_of, 1, stragglers=bad, b_max=b_max)
            args = ({{k: jnp.asarray(v) for k, v in sb.arrays.items()}},
                    jnp.asarray(bp.blk_slot), jnp.asarray(bp.blk_include),
                    jnp.asarray(bp.n_blocks)[:, None], jnp.float32(LR))
            if comp:
                pr, op, cs, m = step(pr, op, cs, *args)
                new_p, new_o = pr, op
                np.savez(os.path.join(OUT, f"comp_state_{{s}}.npz"),
                         *flat(cs["ef"]), *flat(cs["scale"]))
            else:
                new_p, new_o, _, m = step(copy(params), copy(opt), None, *args)
            name = f"{{tag}}_{{''.join(map(str, bad))}}_{{s}}"
            np.savez(os.path.join(OUT, name + ".npz"),
                     loss=np.asarray(m["loss"]), gnorm=np.asarray(m["grad_norm"]),
                     *(flat(new_p) + flat(new_o["m"])))

# Compression alone over 3 steps (tests/test_distributed.py's harness).
cmesh = make_mesh((4,), ("data",))
f = jax.jit(shard_map(lambda g, st: compression.compress_decompress(g, st, "data"),
                      mesh=cmesh, in_specs=(P("data"), P()), out_specs=(P(), P()),
                      axis_names={{"data"}}, check_vma=False))
rng = np.random.default_rng(0)
gs = [rng.normal(size=(4, 8, 8)).astype(np.float32) * 0.01 for _ in range(3)]
st = compression.init_state({{"w": jnp.zeros((8, 8))}})
reds = []
with set_mesh(cmesh):
    for g in gs:
        red, st = f({{"w": jnp.asarray(g.reshape(32, 8))}}, st)
        reds.append(np.asarray(red["w"]))
np.savez(os.path.join(OUT, "compress3.npz"), grads=np.stack(gs),
         reduced=np.stack(reds), ef=np.asarray(st["ef"]["w"]),
         scale=np.asarray(st["scale"]["w"]))

# The trainer: 3 steps with a checkpoint after step 2, then a resumed run.
from repro.launch.train import main
args = {train_args!r}
ck = os.path.join(OUT, "ckpt")
res["main3"] = main(args + ["--steps", "3", "--ckpt-dir", ck, "--ckpt-every", "2"])
shutil.copytree(ck, os.path.join(OUT, "ckpt_port"))
res["resumed4"] = main(args + ["--steps", "4", "--ckpt-dir", ck, "--resume"])
with open(os.path.join(OUT, "res.json"), "w") as fh:
    json.dump(res, fh)
print("done")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ref_train"))
    code = _REFERENCE.format(out=out, n=N, g=G, j=J, seq=SEQ, lr=STEP_LR,
                             train_args=TRAIN_ARGS)
    assert "done" in run_with_devices(code, n_devices=4)
    with open(os.path.join(out, "res.json")) as fh:
        res = json.load(fh)
    return out, res


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------- #
# Losses
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("s,chunk", [(40, 16), (48, 16), (40, 512)])
def test_chunked_cross_entropy_matches_reference(s, chunk):
    """Value and gradients (hidden, unembed) against
    ``jax.value_and_grad`` of the reference's scan; a last chunk that is
    shorter than the rest (the reference pads it with masked rows), whole
    chunks, one chunk; a mask with zeros."""
    rng = np.random.default_rng(s + chunk)
    h = rng.normal(size=(2, s, 24)).astype(np.float32)
    u = (rng.normal(size=(24, 50)) * 0.3).astype(np.float32)
    y = rng.integers(0, 50, size=(2, s)).astype(np.int32)
    m = (rng.random((2, s)) > 0.2).astype(np.float32)

    def ref(h_, u_):
        nll, ntok = ref_losses.chunked_cross_entropy(
            h_, u_, jnp.asarray(y), jnp.asarray(m), chunk=chunk)
        return nll, ntok

    (nll_ref, ntok_ref), (gh_ref, gu_ref) = jax.value_and_grad(
        ref, argnums=(0, 1), has_aux=True)(jnp.asarray(h), jnp.asarray(u))
    ht, ut = (torch.tensor(a, requires_grad=True) for a in (h, u))
    nll, ntok = losses.chunked_cross_entropy(ht, ut, torch.as_tensor(y),
                                             torch.as_tensor(m), chunk=chunk)
    gh, gu = torch.autograd.grad(nll, (ht, ut))
    assert _rel(nll.detach(), nll_ref) < 1e-5
    assert float(ntok) == float(ntok_ref)
    assert _rel(gh, gh_ref) < 1e-5 and _rel(gu, gu_ref) < 1e-5


def test_lm_loss_with_a_loss_mask_matches_reference():
    rng = np.random.default_rng(3)
    h = rng.normal(size=(2, 30, 16)).astype(np.float32)
    u = (rng.normal(size=(16, 40)) * 0.3).astype(np.float32)
    toks = rng.integers(0, 40, size=(2, 30)).astype(np.int32)
    mask = np.concatenate([np.zeros((2, 6)), np.ones((2, 24))], 1).astype(
        np.float32)
    nll_ref, m_ref = ref_losses.lm_loss(jnp.asarray(h), jnp.asarray(u),
                                        jnp.asarray(toks), chunk=8,
                                        loss_mask=jnp.asarray(mask))
    nll, m = losses.lm_loss(torch.as_tensor(h), torch.as_tensor(u),
                            torch.as_tensor(toks), chunk=8,
                            loss_mask=torch.as_tensor(mask))
    assert _rel(nll, nll_ref) < 1e-5
    assert float(m["n_tokens"]) == float(m_ref["n_tokens"]) == 2 * 24


# ---------------------------------------------------------------------- #
# Optimizer
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gscale", [0.01, 10.0])
def test_adamw_matches_reference(dtype, gscale):
    """Three updates of a matrix, a vector and a scalar (decay on matrices
    only), with the global-norm clip idle (0.01) and active (10.0); new
    params, moments and count against ``repro.optim.adamw``."""
    rng = np.random.default_rng(int(gscale * 100))
    shapes = {"w": (6, 5), "b": (5,), "s": ()}
    p_np = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    p_ref = {k: jnp.asarray(v).astype(dtype) for k, v in p_np.items()}
    p = {k: torch.as_tensor(np.array(v.astype(jnp.float32))).to(
        getattr(torch, dtype)) for k, v in p_ref.items()}
    st_ref, st = ref_adamw.init(p_ref), adamw.init(p)
    for i in range(3):
        g_np = {k: (rng.normal(size=s) * gscale).astype(np.float32)
                for k, s in shapes.items()}
        lr = ref_warmup_cosine(i + 1, 1e-2, 2, 10)
        p_ref, st_ref, m_ref = ref_adamw.update(
            {k: jnp.asarray(v) for k, v in g_np.items()}, st_ref, p_ref, lr)
        p, st, m = adamw.update({k: torch.as_tensor(v) for k, v in g_np.items()},
                                st, p, warmup_cosine(i + 1, 1e-2, 2, 10))
        assert _rel(m["grad_norm"], m_ref["grad_norm"]) < 1e-6
        for k in shapes:
            assert p[k].dtype == getattr(torch, dtype)
            assert _rel(p[k].float(), p_ref[k].astype(jnp.float32)) < 1e-6
            assert _rel(st["m"][k], st_ref["m"][k]) < 1e-6
            assert _rel(st["v"][k], st_ref["v"][k]) < 1e-6
        assert int(st["count"]) == int(st_ref["count"]) == i + 1


def test_warmup_cosine_and_constant_match_reference():
    for step in range(0, 14):
        assert _rel(warmup_cosine(step, 3e-4, 3, 12),
                    ref_warmup_cosine(step, 3e-4, 3, 12)) < 1e-6
    from repro.optim import constant as ref_constant
    from repro_torch.optim import constant
    assert float(constant(5, 2e-3)) == float(ref_constant(5, 2e-3))


# ---------------------------------------------------------------------- #
# Compression and data
# ---------------------------------------------------------------------- #
def test_compression_error_feedback_matches_reference(reference):
    """Four workers' gradients over 3 steps, each worker's error feedback
    carried into its next step: every step's reduced gradient and the final
    scale bitwise the reference's; worker 0's error feedback (the
    reference's host copy of its state) within 1e-6 of the gradients'
    largest value (XLA contracts ``g - q * scale`` into one fused
    multiply-add, rounded once where the port rounds twice)."""
    out, _ = reference
    ref = _npz(os.path.join(out, "compress3.npz"))
    st = compression.init_state({"w": torch.zeros(8, 8)}, n_workers=4)
    for step, g in enumerate(ref["grads"]):
        red, st = compression.compress_decompress(
            [{"w": torch.as_tensor(gw)} for gw in g], st)
        np.testing.assert_array_equal(red["w"].numpy(), ref["reduced"][step])
    np.testing.assert_allclose(st["ef"]["w"][0].numpy(), ref["ef"], rtol=0,
                               atol=1e-6 * np.abs(ref["grads"]).max())
    np.testing.assert_array_equal(st["scale"]["w"].numpy(), ref["scale"])


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "internvl2-2b",
                                  "hubert-xlarge"])
def test_token_pipeline_arrays_are_bitwise_the_reference(arch):
    cfg, ref_cfg = get_config(arch).reduced(), ref_configs.get_config(
        arch).reduced()
    mine = TokenPipeline(cfg, cyclic_placement(4, 8, 2), seq_len=24,
                         tile_samples=2, seed=5)
    ref = RefPipeline(ref_cfg, ref_cyclic(4, 8, 2), seq_len=24,
                      tile_samples=2, seed=5)
    assert mine.t_stage == ref.t_stage
    for step in (0, 3):
        a, b = mine.staged_for_step(step), ref.staged_for_step(step)
        np.testing.assert_array_equal(a.slot_of, b.slot_of)
        assert sorted(a.arrays) == sorted(b.arrays)
        for k in a.arrays:
            assert a.arrays[k].dtype == b.arrays[k].dtype
            np.testing.assert_array_equal(a.arrays[k], b.arrays[k])
    ga, gb = mine.global_batch(1), ref.global_batch(1)
    for k in ga:
        np.testing.assert_array_equal(ga[k], gb[k])


# ---------------------------------------------------------------------- #
# loss_fn and its gradients
# ---------------------------------------------------------------------- #
@REF_MOE_WARNING
@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_fn_and_gradients_match_reference(arch):
    """``loss_fn`` (LM, VLM with its text-only mask, encoder with labels;
    the MoE aux term) and every parameter's gradient against
    ``jax.value_and_grad`` of the reference's (under ``jax.jit``: eager
    dispatch of its scans is slow), at 80 positions (> the
    reduced attn_chunk 64, so attention takes the chunked scan, under
    remat). Each gradient leaf within 1e-4 of its reference's largest
    value."""
    cfg, ref_cfg = _fp32(arch)
    ref_params = _ref_params(arch)
    batch = demo_batch(cfg, "train", 2, 80, seed=11)
    ref_bundle = ref_build_model(ref_cfg)
    (total_ref, m_ref), g_ref = jax.jit(jax.value_and_grad(
        ref_bundle.loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, ref_params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    bundle = build_model(cfg, device="cpu")
    params = params_from_reference(ref_params, cfg, "cpu")
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    total, m = bundle.loss_fn(params, batch)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    assert _rel(total.detach(), total_ref) < TOL
    assert float(m["n_tokens"]) == float(m_ref["n_tokens"])
    assert _rel(m["aux_loss"].detach(), m_ref["aux_loss"]) < TOL
    ref_leaves = jax.tree.leaves(g_ref)
    assert len(ref_leaves) == len(grads)
    for g, want in zip(grads, ref_leaves):
        got = np.zeros(want.shape, np.float32) if g is None else g.numpy()
        assert _rel(got, want) < TOL


# ---------------------------------------------------------------------- #
# The train steps
# ---------------------------------------------------------------------- #
ACC_TOL = {"float32": TOL, "bfloat16": 1e-2}


def _usec_cell(accum="float32"):
    cfg = dataclasses.replace(get_config("stablelm-1.6b").reduced(),
                              param_dtype="float32", grad_accum_dtype=accum)
    p = cyclic_placement(N, G, J)
    pipe = TokenPipeline(cfg, p, seq_len=SEQ, tile_samples=1, seed=0)
    plan = compile_plan(p, solve_assignment(p, np.ones(N), stragglers=1),
                        rows_per_tile=1, stragglers=1)
    bundle = build_model(cfg, device="cpu")
    params = params_from_reference(_ref_params("stablelm-1.6b"), cfg, "cpu")
    return bundle, params, pipe, plan, int(plan.n_valid.max()) + 1


def _step_args(pipe, plan, b_max, bad=(), step=0):
    sb = pipe.staged_for_step(step)
    bp = block_plan(plan, sb.slot_of, 1, stragglers=bad, b_max=b_max)
    return (sb.arrays, bp.blk_slot, bp.blk_include, bp.n_blocks[:, None],
            torch.tensor(STEP_LR))


def _check_step(ref, m, new_p, new_o, tol=TOL, quantized=False):
    """Loss, gradient norm and every leaf within ``tol`` of the reference's
    largest value. ``quantized``: int8-compressed gradients, where an fp32
    gradient within rounding of a half step quantizes to the next integer
    in one package and not the other; at most 0.1 % of a leaf's elements
    may then differ, each by a few quanta (2e-2 of the largest value)."""
    assert _rel(m["loss"], ref["loss"]) < TOL
    assert _rel(m["grad_norm"], ref["gnorm"]) < tol
    got = tree_leaves(new_p) + tree_leaves(new_o["m"])
    want = [ref[f"arr_{i}"] for i in range(len(got))]
    for g, w in zip(got, want):
        if not quantized:
            assert _rel(g, w) < tol
            continue
        off = np.abs(g.numpy() - w) > tol * np.abs(w).max()
        assert off.mean() <= 1e-3 and _rel(g, w) < 2e-2


@pytest.mark.parametrize("accum,bad", [("float32", ()), ("float32", (1,)),
                                       ("bfloat16", ())])
def test_usec_step_matches_reference(reference, accum, bad):
    """One usec step (4 workers, S = 1) from the reference's weights, with
    no drop and with worker 1 dropped, accumulating in fp32 and in bf16:
    loss, gradient norm, every updated parameter and first moment (= 0.1 x
    the clipped gradient) against the reference's shard_map step."""
    out, _ = reference
    bundle, params, pipe, plan, b_max = _usec_cell(accum)
    step = make_usec_train_step(bundle, pipe.t_stage, b_max)
    new_p, new_o, _, m = step(params, adamw.init(params), None,
                              *_step_args(pipe, plan, b_max, bad))
    tag = {"float32": "fp32", "bfloat16": "bf16"}[accum]
    _check_step(_npz(os.path.join(out, f"{tag}_{''.join(map(str, bad))}_0.npz")),
                m, new_p, new_o, ACC_TOL[accum])


def test_usec_step_with_compression_matches_reference(reference):
    """Two chained compressed steps (each worker's error feedback carried
    into the second): metrics, parameters and moments after each (up to the
    quantizer's rounding ties, see ``_check_step``), and the compression
    state after each (worker 0's error feedback, the scales)."""
    out, _ = reference
    bundle, params, pipe, plan, b_max = _usec_cell()
    step = make_usec_train_step(bundle, pipe.t_stage, b_max,
                                compress_grads=True)
    opt, comp = adamw.init(params), compression.init_state(params, N)
    for s in (0, 1):
        old_sc = [float(x) for x in tree_leaves(comp["scale"])]
        params, opt, comp, m = step(params, opt, comp,
                                    *_step_args(pipe, plan, b_max, step=s))
        _check_step(_npz(os.path.join(out, f"comp__{s}.npz")), m, params, opt,
                    quantized=True)
        ref = _npz(os.path.join(out, f"comp_state_{s}.npz"))
        ef, sc = tree_leaves(comp["ef"]), tree_leaves(comp["scale"])
        for i, s_ in enumerate(sc):
            want_sc = ref[f"arr_{len(ef) + i}"]
            assert _rel(s_, want_sc) < TOL
            # ef = g - q * scale: held to the quantizer's range (127 x the
            # new scale = the largest |g|). A rounding tie (see above) moves
            # q by one, so ef by one quantum of the scale this step
            # quantized with; no element may differ by more.
            diff = np.abs(ef[i][0].numpy() - ref[f"arr_{i}"])
            assert (diff > TOL * 127 * want_sc).mean() <= 1e-3
            assert diff.max() <= 1.01 * old_sc[i]


def test_usec_step_drop_keeps_loss_exact():
    """S = 1: dropping any one worker leaves the combined loss unchanged
    (the redundant copies take over) up to the fp32 sum order."""
    bundle, params, pipe, plan, b_max = _usec_cell()
    step = make_usec_train_step(bundle, pipe.t_stage, b_max)
    losses_ = []
    for bad in [(), (0,), (1,), (2,), (3,)]:
        _, _, _, m = step(params, adamw.init(params), None,
                          *_step_args(pipe, plan, b_max, bad))
        losses_.append(float(m["loss"]))
    assert max(losses_) - min(losses_) < 1e-5, losses_


def test_usec_step_matches_fsdp_step_for_one_worker():
    """One worker, no redundancy, the same data: the uneven-loop step and
    the fsdp step give the same loss, gradient norm and parameters (both
    accumulate in fp32 here)."""
    cfg = dataclasses.replace(get_config("stablelm-1.6b").reduced(),
                              param_dtype="float32",
                              grad_accum_dtype="float32")
    p = cyclic_placement(1, 4, 1)
    pipe = TokenPipeline(cfg, p, seq_len=16, tile_samples=2, seed=0)
    plan = compile_plan(p, solve_assignment(p, np.ones(1), stragglers=0),
                        rows_per_tile=1, stragglers=0)
    bundle = build_model(cfg, device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    sb = pipe.staged_for_step(0)
    bp = block_plan(plan, sb.slot_of, 1)
    lr = torch.tensor(1e-3)
    p1, _, _, m1 = make_usec_train_step(bundle, pipe.t_stage, bp.b_max)(
        params, adamw.init(params), None, sb.arrays, bp.blk_slot,
        bp.blk_include, bp.n_blocks[:, None], lr)
    p2, _, m2 = make_fsdp_train_step(bundle, n_micro=4)(
        params, adamw.init(params), pipe.global_batch(0),
        np.ones(8, np.float32), lr)
    assert _rel(m1["loss"], m2["loss"]) < 1e-5
    assert _rel(m1["grad_norm"], m2["grad_norm"]) < 1e-5
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        assert _rel(a, b) < 1e-5


# ---------------------------------------------------------------------- #
# The trainer
# ---------------------------------------------------------------------- #
def _reference_weights(monkeypatch):
    """``launch.train.main`` builds fp32 configs and starts from the
    reference trainer's init (``PRNGKey(seed)``), carried across."""
    real_get, real_build = port_configs.get_config, port_models.build_model
    monkeypatch.setattr(port_configs, "get_config", lambda name: (
        dataclasses.replace(real_get(name), param_dtype="float32")))

    def build(cfg, device=None, shards=None):
        bundle = real_build(cfg, device=device, shards=shards)
        carried = params_from_reference(_ref_params("stablelm-1.6b"), cfg,
                                        bundle.device, shards)
        return dataclasses.replace(bundle, init=lambda gen: carried)

    monkeypatch.setattr(port_models, "build_model", build)


def test_train_main_matches_reference_trainer(reference, monkeypatch, capsys):
    """Three steps of the same loop (pipeline, scheduler, simulated drops,
    usec step, AdamW with warmup): the last loss within 1e-4 of the
    reference trainer's."""
    _, res = reference
    _reference_weights(monkeypatch)
    loss = port_train.main(TRAIN_ARGS + ["--steps", "3", "--device", "cpu"])
    assert abs(loss - res["main3"]) / abs(res["main3"]) < TOL
    assert "done: 3 steps" in capsys.readouterr().out


def test_train_main_resumes_a_reference_checkpoint(reference, monkeypatch,
                                                   capsys):
    """The reference trainer's checkpoint after step 2 (params, AdamW state,
    the scheduler's speeds) resumed by the port: its step-3 loss within
    1e-4 of the reference's own resumed run."""
    out, res = reference
    _reference_weights(monkeypatch)
    loss = port_train.main(TRAIN_ARGS + [
        "--steps", "4", "--ckpt-dir", os.path.join(out, "ckpt_port"),
        "--resume", "--device", "cpu"])
    assert "at step 2" in capsys.readouterr().out
    assert abs(loss - res["resumed4"]) / abs(res["resumed4"]) < TOL


_SHARD_ARGS = ["--arch", "glm4-9b", "--reduced", "--workers", "2",
               "--seq-len", "32", "--tile-samples", "1", "--steps", "3",
               "--straggler-tolerance", "1", "--log-every", "1",
               "--device", "cpu"]


def _model_shards_job(rank, world, store, out_dir):
    """``main --model-shards 2`` on one of 2 gloo ranks (fp32 configs)."""
    import contextlib
    import io

    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    real = port_configs.get_config
    port_configs.get_config = lambda name: dataclasses.replace(
        real(name), param_dtype="float32")
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            port_train.main(_SHARD_ARGS + ["--model-shards", "2"])
        with open(os.path.join(out_dir, f"shards{rank}.txt"), "w") as fh:
            fh.write(buf.getvalue())
    finally:
        port_configs.get_config = real
        torch.distributed.destroy_process_group()


def test_train_main_refuses_model_shards(tmp_path, monkeypatch, capsys):
    """``--model-shards 2`` without the ranks to hold them (one process)
    raises; under 2 gloo ranks it trains, rank 0 printing the one-process
    run's losses (the model split over the ranks: 2 x 1 mesh, model
    indices 0 and 1)."""
    with pytest.raises(ValueError, match="torch.distributed.run"):
        port_train.main(["--arch", "stablelm-1.6b", "--reduced",
                         "--model-shards", "2", "--device", "cpu"])
    tmp = str(tmp_path)
    torch.multiprocessing.start_processes(
        _model_shards_job, args=(2, os.path.join(tmp, "store"), tmp),
        nprocs=2, start_method="spawn")
    with open(os.path.join(tmp, "shards0.txt")) as fh:
        out = fh.read()
    with open(os.path.join(tmp, "shards1.txt")) as fh:
        assert fh.read() == ""
    real = port_configs.get_config
    monkeypatch.setattr(port_configs, "get_config", lambda name: (
        dataclasses.replace(real(name), param_dtype="float32")))
    port_train.main(_SHARD_ARGS)
    one = capsys.readouterr().out
    pick = lambda text: [ln.split(" c*=")[0] for ln in text.splitlines()
                         if ln.startswith("step ")]
    assert len(pick(out)) == 3 and pick(out) == pick(one)
    for r in range(2):
        assert f'rank {r} of 2: {{"workers": [0, 1], "model_index": {r}' \
            in out


# ---------------------------------------------------------------------- #
# The differentiable flash route
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("sq,skv,h,hk,causal,window", [
    (150, 150, 4, 2, True, None), (150, 150, 2, 2, False, None),
    (100, 170, 4, 1, True, 48)])
def test_flash_attention_fn_gradients_equal_the_chunked_scan(sq, skv, h, hk,
                                                             causal, window):
    """``FlashAttentionFn`` on host tensors (its forward takes the kernel's
    plain version there) against autograd through ``chunked_attention``:
    the same output and, through the per-query-chunk recompute of its
    backward, the same dq, dk, dv; causal aligned to the end of the KV
    sequence when sq != skv, as the kernel aligns it."""
    rng = np.random.default_rng(sq + skv)
    q, k, v = (torch.tensor(rng.normal(size=shp).astype(np.float32),
                            requires_grad=True)
               for shp in ((2, sq, h, 32), (2, skv, hk, 32), (2, skv, hk, 32)))
    g = torch.as_tensor(rng.normal(size=(2, sq, h, 32)).astype(np.float32))
    o = FlashAttentionFn.apply(q, k, v, causal, window, 64)
    grads = torch.autograd.grad(o, (q, k, v), g)
    o_ref = chunked_attention(q, k, v, causal=causal, window=window,
                              chunk=64, q_offset=skv - sq)
    grads_ref = torch.autograd.grad(o_ref, (q, k, v), g)
    assert _rel(o.detach(), o_ref.detach()) < 1e-5
    for a, b in zip(grads, grads_ref):
        assert _rel(a, b) < 1e-5


def test_raw_flash_kernel_refuses_grad_before_the_cuda_check():
    """``flash_attention_cuda`` has no backward: with grad enabled and an
    input that requires grad it raises at once (on host tensors too,
    ahead of its device check), instead of returning a detached output."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    q = torch.zeros(1, 2, 8, 32, requires_grad=True)
    k = v = torch.zeros(1, 2, 8, 32)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention_cuda(q, k, v)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(q, k, v)


@pytest.mark.parametrize("arch", ["internvl2-2b", "hubert-xlarge"])
def test_flash_route_under_remat_keeps_the_gradients(arch, monkeypatch):
    """The card's route through the stack, on the host: every long
    attention through ``FlashAttentionFn`` (forward on the kernel's plain
    version, the scan recomputed in the backward) inside the remat blocks
    (``torch.utils.checkpoint`` runs each block's forward again in the
    backward). ``loss_fn`` and every gradient equal the plain route's
    within 1e-5 of each leaf's largest value."""
    from repro_torch.models import attention

    cfg, _ = _fp32(arch)
    assert cfg.remat
    bundle = build_model(cfg, device="cpu")
    params = params_from_reference(_ref_params(arch), cfg, "cpu")
    batch = demo_batch(cfg, "train", 2, 150, seed=2)

    def run():
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        from repro_torch.models.transformer import tree_unflatten

        total, _ = bundle.loss_fn(tree_unflatten(params, leaves), batch)
        return total, torch.autograd.grad(total, leaves, allow_unused=True)

    want, g_want = run()
    calls = []

    def kernel_route(q, k, v, causal, window, chunk):
        calls.append(causal)
        return FlashAttentionFn.apply(q, k, v, causal, window, chunk)

    monkeypatch.setattr(attention, "long_attention", kernel_route)
    got, g_got = run()
    # Each layer's forward twice (the remat replays it): 2 x 2 layers.
    assert calls == [cfg.decoder] * 4
    assert _rel(got.detach(), want.detach()) < 1e-5
    for a, b in zip(g_got, g_want):
        if b is None:
            assert a is None
            continue
        assert _rel(a, b) < 1e-5
