"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's.

Numpy-seeded inputs and the reference's own ``init_moe`` weights (carried
across with ``params_from_reference``) go through ``repro.models.moe`` and
the port on the CPU, for both MoE archs at reduced size (4 experts; top-2
with 2 shared experts, top-1 with 1), in fp32 and bf16, at the default
capacity, at ``capacity_factor`` 0.5 (choices dropped) and with
``moe_chunk`` 16 over 66 tokens (5 chunks, the last padded with zero rows).
The reference's routing (its ``jax.lax.top_k`` results and the slot
positions it one-hots) is read by wrapping those two functions while it runs
eagerly; the port's by wrapping its ``route``. Top-k indices and keep masks
must be equal exactly. Tolerances: fp32 outputs 1e-5 (one op chain, summed
in another order); bf16 outputs rtol 1e-2 plus atol 1e-2 of the largest
output (both sides round the experts' activations to bf16, in another
order: about 2.5 bf16 ulps of the largest value); ``aux`` 1e-6.
Tests that run the reference ignore the one ``DeprecationWarning`` it raises
itself (``jax.nn.one_hot`` of its float slot positions,
``src/repro/models/moe.py:156``), which the JAX package cannot change.
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.configs as ref_configs  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, param_count, params_from_reference  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ARCHS = ["deepseek-moe-16b", "llama4-scout-17b-a16e"]
DTYPES = ["float32", "bfloat16"]
VARIANTS = {"default": {}, "drops": {"capacity_factor": 0.5},
            "chunked": {"moe_chunk": 16}}
SHAPE = (2, 33, 64)  # (B, S, D): 66 tokens, d_model of the reduced configs
REF_MOE_WARNING = pytest.mark.filterwarnings(
    "ignore:jax.nn.one_hot input should be integer-typed:DeprecationWarning")


def _cfgs(arch, dtype, variant="default"):
    kw = dict(param_dtype=dtype, **VARIANTS[variant])
    return (dataclasses.replace(get_config(arch).reduced(), **kw),
            dataclasses.replace(ref_configs.get_config(arch).reduced(), **kw))


def _setup(arch, dtype, variant="default", seed=0):
    """(port cfg, ref cfg, port params, ref params, x as numpy fp32)."""
    cfg, ref_cfg = _cfgs(arch, dtype, variant)
    p_ref = ref_moe.init_moe(jax.random.PRNGKey(seed), ref_cfg)
    p = params_from_reference(jax.tree.map(np.asarray, p_ref), cfg, "cpu")
    x = np.random.default_rng(seed + 1).normal(size=SHAPE).astype(np.float32)
    return cfg, ref_cfg, p, p_ref, x


def _run_reference(p_ref, x, ref_cfg, monkeypatch):
    """The reference's ``apply_moe`` run eagerly: (out, aux, routing), with
    routing one (top-k indices, keep mask) pair per chunk."""
    top_k, one_hot = jax.lax.top_k, jax.nn.one_hot
    idx, pos = [], []

    def top_k_spy(operand, k):
        vals, i = top_k(operand, k)
        idx.append(np.asarray(i))
        pos.append([])
        return vals, i

    def one_hot_spy(a, num_classes, **kw):
        # A chunk's first call one-hots its expert indices, the next k its
        # slot positions against the capacity.
        pos[-1].append((np.asarray(a), num_classes))
        return one_hot(a, num_classes, **kw)

    monkeypatch.setattr(jax.lax, "top_k", top_k_spy)
    monkeypatch.setattr(jax.nn, "one_hot", one_hot_spy)
    xj = jnp.asarray(x).astype(ref_cfg.param_dtype)
    with jax.disable_jit():
        out, aux = ref_moe.apply_moe(p_ref, xj, ref_cfg)
    monkeypatch.undo()
    keep = [np.stack([p < c for p, c in calls[1:]], axis=1) for calls in pos]
    return (np.asarray(out.astype(jnp.float32)), float(aux),
            list(zip(idx, keep)))


def _run_port(p, x, cfg, monkeypatch):
    """The port's ``apply_moe``: (out, aux, routing), routing as above."""
    routes = []
    real = moe.route

    def route_spy(router, xt, cfg_):
        r = real(router, xt, cfg_)
        routes.append(r)
        return r

    monkeypatch.setattr(moe, "route", route_spy)
    xt = torch.as_tensor(x).to(getattr(torch, cfg.param_dtype))
    out, aux = moe.apply_moe(p, xt, cfg)
    monkeypatch.undo()
    return (out.float().numpy(), float(aux),
            [(r.idx.numpy(), r.keep.numpy()) for r in routes], routes)


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-2,
                                   atol=1e-2 * float(np.abs(want).max()))


def _same_routing(got, want):
    assert len(got) == len(want)
    for (gi, gk), (wi, wk) in zip(got, want):
        assert np.array_equal(gi, wi)
        assert np.array_equal(gk, wk)


@REF_MOE_WARNING
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_reference(arch, dtype, variant, monkeypatch):
    cfg, ref_cfg, p, p_ref, x = _setup(arch, dtype, variant)
    out_ref, aux_ref, routing_ref = _run_reference(p_ref, x, ref_cfg,
                                                   monkeypatch)
    out, aux, routing, routes = _run_port(p, x, cfg, monkeypatch)
    _same_routing(routing, routing_ref)
    _close(out, out_ref, dtype)
    assert abs(aux - aux_ref) < 1e-6
    t = SHAPE[0] * SHAPE[1]
    if variant == "chunked":
        assert len(routes) == -(-t // 16) == 5
        assert all(r.capacity == max(int(16 * cfg.top_k / 4 * 1.25), 1)
                   for r in routes)
    if variant == "drops":
        assert any(bool((~r.keep).any()) for r in routes)


def _chunks(x, cfg):
    """The (T, D) chunks ``apply_moe`` routes, zero-padded."""
    xt = torch.as_tensor(x).to(getattr(torch, cfg.param_dtype))
    xt = xt.reshape(-1, x.shape[-1])
    chunk = min(cfg.moe_chunk, xt.shape[0])
    pad = -xt.shape[0] % chunk
    return torch.nn.functional.pad(xt, (0, 0, 0, pad)).split(chunk)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_main_path_matches_plain(arch, dtype, variant):
    """Index dispatch and combine against the literal one-hot einsums:
    the same top-k indices and keep masks, the dispatched (E, C, D) buffer
    bitwise equal, the outputs and aux within tolerance."""
    cfg, _, p, _, x = _setup(arch, dtype, variant, seed=3)
    for xt in _chunks(x, cfg):
        r = moe.route(p["router"], xt, cfg)
        out, aux = moe.moe_chunk(p, xt, cfg)
        out_p, aux_p, idx_p, keep_p, xin_p = moe.moe_chunk_plain(p, xt, cfg)
        assert torch.equal(r.idx, idx_p)
        assert torch.equal(r.keep, keep_p)
        assert torch.equal(moe.dispatch(xt, r), xin_p)
        _close(out.float(), out_p.float(), dtype)
        assert abs(float(aux) - float(aux_p)) < 1e-6


@REF_MOE_WARNING
@pytest.mark.parametrize("arch", ARCHS)
def test_ties_route_like_lax_top_k(arch, monkeypatch):
    """Exact ties in the router probs: experts 0 and 1 (and 2 and 3) get
    the same router column, and a third of the tokens are zero rows
    (uniform probs, as the chunk loop's padding). The port picks the lower
    index first, as ``jax.lax.top_k``: the same order, keep masks, outputs
    and aux as the reference."""
    cfg, ref_cfg, _, p_ref, x = _setup(arch, "float32", "chunked", seed=5)
    router = np.array(p_ref["router"])
    router[:, 1], router[:, 3] = router[:, 0], router[:, 2]
    p_ref = dict(p_ref, router=jnp.asarray(router))
    p = params_from_reference(jax.tree.map(np.asarray, p_ref), cfg, "cpu")
    x[:, ::3] = 0.0
    probs = jax.nn.softmax(jnp.asarray(x.reshape(-1, SHAPE[-1])) @ router, -1)
    want = np.asarray(jax.lax.top_k(probs, cfg.top_k)[1])
    got = moe.route(p["router"], torch.as_tensor(x.reshape(-1, SHAPE[-1])),
                    cfg).idx.numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(want[::3][:, 0], np.zeros(len(want[::3]), int))
    out_ref, aux_ref, routing_ref = _run_reference(p_ref, x, ref_cfg,
                                                   monkeypatch)
    out, aux, routing, _ = _run_port(p, x, cfg, monkeypatch)
    _same_routing(routing, routing_ref)
    _close(out, out_ref, "float32")
    assert abs(aux - aux_ref) < 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_port_moe_raises_no_warning(arch):
    """The port computes slot positions in integers: no warning, even with
    every warning an error (the reference's float one-hot raises one)."""
    cfg, _, p, _, x = _setup(arch, "bfloat16", "chunked")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out, aux = moe.apply_moe(p, torch.as_tensor(x).bfloat16(), cfg)
    assert out.shape == SHAPE and bool(torch.isfinite(out.float()).all())
    assert bool(torch.isfinite(aux))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_layout_matches_reference(arch, dtype):
    """The port's ``init_moe`` gives the reference's tree (keys, shapes,
    dtypes: the router in fp32 whatever ``param_dtype``), stacked on a
    leading layer axis, with each leaf drawn at ``d_in ** -0.5``."""
    cfg, ref_cfg = _cfgs(arch, dtype)
    ref = jax.tree.map(np.asarray, ref_moe.init_moe(jax.random.PRNGKey(0),
                                                    ref_cfg))
    mine = moe.init_moe(torch.Generator().manual_seed(0), cfg, lead=(3,))

    def layout(tree):
        if isinstance(tree, dict):
            return {k: layout(v) for k, v in tree.items()}
        return tuple(tree.shape), str(tree.dtype).replace("torch.", "")

    assert layout(mine) == jax.tree.map(
        lambda a: ((3,) + a.shape, str(a.dtype)), ref)
    assert mine["router"].dtype == torch.float32
    for name, d_in in (("router", cfg.d_model), ("w_up", cfg.d_model),
                       ("w_down", cfg.moe_d_ff)):
        std = float(mine[name].float().std())
        assert abs(std - d_in ** -0.5) < 0.1 * d_in ** -0.5


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_equals_n_params(arch):
    """Every leaf of a reduced MoE model is counted, and the count is the
    config's analytic ``n_params`` (the full-width count is checked on the
    card by ``chip_smoke.py``)."""
    cfg = get_config(arch).reduced()
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    assert param_count(params) == cfg.n_params()
