"""The port's model stack (serving path) against the JAX package's.

Same numpy-seeded inputs and the same weights (the reference's init carried
across with ``params_from_reference``) go through ``repro.models`` and
``repro_torch.models`` on the CPU, in fp32: layers, the attention paths and
reduced glm4-9b / stablelm-1.6b / qwen1.5-110b / nemotron-4-15b (layernorm,
squared-ReLU MLP), the MoE archs, mamba2-370m (SSD), recurrentgemma-2b
(RG-LRU + local attention; also at 8 layers, so its two trailing layers
run) and internvl2-2b (a patch prefix, then text) end to end (prefill
logits and caches, decode logits, greedy tokens against
``examples/decode_demo.py``), and every arch's full-width parameter tree
(hubert-xlarge's too) against the reference's ``jax.eval_shape``.
Tolerances: 1e-5 for a layer or an attention call (one fp32 op chain,
summed in another order), 1e-4 relative for a whole model's logits.
"""

import dataclasses
import functools
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from conftest import REPO  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import make_cache as ref_make_cache  # noqa: E402
from repro.models.model import param_count as ref_param_count  # noqa: E402
from repro_torch.configs import demo_batch, get_config, list_archs  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import (  # noqa: E402
    build_model,
    make_cache,
    param_count,
    params_from_reference,
)
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.transformer import tree_leaves  # noqa: E402

TOL = 1e-5
MODEL_ARCHS = ["glm4-9b", "stablelm-1.6b", "qwen1.5-110b", "nemotron-4-15b",
               "deepseek-moe-16b", "llama4-scout-17b-a16e", "mamba2-370m",
               "recurrentgemma-2b", "internvl2-2b"]
RECURRENT_ARCHS = ["mamba2-370m", "recurrentgemma-2b"]
# Every arch of the registry; the encoder (no decode) is served by
# tests/test_torch_frontends.py.
PORTED = set(MODEL_ARCHS) | {"hubert-xlarge"}
REF_MOE_WARNING = pytest.mark.filterwarnings(
    "ignore:jax.nn.one_hot input should be integer-typed:DeprecationWarning")
B, DECODE_STEPS = 2, 8


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _pair(rng, shape, scale=1.0):
    a = (rng.normal(size=shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.as_tensor(a)


def _fp32(cfg, n_layers=None):
    cfg = dataclasses.replace(cfg.reduced(), param_dtype="float32")
    return cfg if n_layers is None else dataclasses.replace(cfg,
                                                            n_layers=n_layers)


# ---------------------------------------------------------------------- #
# Layers
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm_matches_reference(kind):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng, (2, 5, 48), 3.0)
    sj, st = _pair(rng, (48,))
    p_ref, p = {"scale": sj}, {"scale": st}
    if kind == "layernorm":
        bj, bt = _pair(rng, (48,))
        p_ref["bias"], p["bias"] = bj, bt
    _close(layers.apply_norm(p, xt, kind), ref_layers.apply_norm(p_ref, xj, kind))


def test_rope_matches_reference():
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng, (2, 40, 3, 32))
    pos = np.arange(1000, 1040)
    _close(layers.rope(xt, torch.as_tensor(pos), 10000.0),
           ref_layers.rope(xj, jnp.asarray(pos), 10000.0))


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "squared_relu"])
def test_apply_mlp_matches_reference(act):
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng, (2, 7, 32))
    names = ("w_gate", "w_up", "w_down") if act in layers.GATED_ACTS \
        else ("w_up", "w_down")
    p_ref, p = {}, {}
    for n in names:
        p_ref[n], p[n] = _pair(rng, (48, 32) if n == "w_down" else (32, 48),
                               0.2)
    _close(layers.apply_mlp(p, xt, act), ref_layers.apply_mlp(p_ref, xj, act))


def test_init_writes_each_leaf_in_param_dtype():
    cfg = get_config("glm4-9b").reduced()
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(params))
    w = params["stack"]["blocks"][0]["ffn"]["w_gate"]
    assert tuple(w.shape) == (cfg.n_layers, cfg.d_model, cfg.d_ff)
    std = float(w.float().std())
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


@pytest.mark.parametrize("arch", sorted(PORTED))
def test_params_and_cache_layout_match_reference(arch):
    """The port's init, ``make_cache`` and ``param_count`` give the
    reference's trees: same structure, shapes and dtypes."""
    cfg = get_config(arch).reduced()
    ref_cfg = ref_configs.get_config(arch).reduced()
    mine = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    ref = ref_build_model(ref_cfg).init(jax.random.PRNGKey(0))
    assert param_count(mine) == ref_param_count(ref)

    def layout(tree):
        return [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
                for t in tree]

    assert layout(tree_leaves(mine)) == layout(jax.tree.leaves(ref))
    cache = make_cache(cfg, B, 50, device="cpu")
    assert layout(tree_leaves(cache)) == layout(
        jax.tree.leaves(ref_make_cache(ref_cfg, B, 50)))
    carried = params_from_reference(jax.tree.map(np.asarray, ref), cfg, "cpu")
    assert layout(tree_leaves(carried)) == layout(tree_leaves(mine))
    for got, want in zip(tree_leaves(carried), jax.tree.leaves(ref)):
        assert np.array_equal(got.float().numpy(),
                              np.asarray(want, np.float32))


# ---------------------------------------------------------------------- #
# Attention
# ---------------------------------------------------------------------- #
def _attn_cfg(qkv_bias=False, window=None):
    return dataclasses.replace(_fp32(get_config("glm4-9b")), n_heads=4,
                               n_kv_heads=2, qkv_bias=qkv_bias, window=window)


def _attn_params(cfg, seed):
    """One layer's attention weights as (reference tree, port tree)."""
    rng = np.random.default_rng(seed)
    d, hd = cfg.d_model, cfg.head_dim
    shapes = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
              "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d)}
    if cfg.qkv_bias:
        shapes.update(bq=(cfg.n_heads * hd,), bk=(cfg.n_kv_heads * hd,),
                      bv=(cfg.n_kv_heads * hd,))
    pairs = {n: _pair(rng, s, d ** -0.5) for n, s in shapes.items()}
    return ({n: a for n, (a, _) in pairs.items()},
            {n: t for n, (_, t) in pairs.items()})


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_qkv_matches_reference(qkv_bias):
    cfg = _attn_cfg(qkv_bias=qkv_bias)
    p_ref, p = _attn_params(cfg, 3)
    xj, xt = _pair(np.random.default_rng(4), (2, 9, cfg.d_model))
    pos = np.arange(9)
    for got, want in zip(attn.qkv(p, xt, cfg, torch.as_tensor(pos)),
                         ref_attn.qkv(p_ref, xj, cfg, jnp.asarray(pos))):
        _close(got, want)


@pytest.mark.parametrize("sq,skv,h,hk,causal,window,q_chunk,q_offset", [
    (192, 192, 4, 2, True, None, None, 0),      # tests/test_kernels.py's
    (100, 100, 4, 1, True, 24, 32, 0),          # GQA 4:1, window, q chunks
    (70, 130, 2, 2, False, None, None, 0),      # bidirectional, ragged
    (40, 130, 4, 2, True, None, None, 90),      # trailing queries
])
def test_chunked_attention_matches_reference(sq, skv, h, hk, causal, window,
                                             q_chunk, q_offset):
    rng = np.random.default_rng(sq + skv)
    qj, qt = _pair(rng, (2, sq, h, 32))
    kj, kt = _pair(rng, (2, skv, hk, 32))
    vj, vt = _pair(rng, (2, skv, hk, 32))
    kw = dict(causal=causal, window=window, chunk=64, q_chunk=q_chunk,
              q_offset=q_offset)
    _close(attn.chunked_attention(qt, kt, vt, **kw),
           ref_attn.chunked_attention(qj, kj, vj, **kw))


@pytest.mark.parametrize("masked", [False, True])
def test_full_attention_matches_reference(masked):
    rng = np.random.default_rng(5)
    qj, qt = _pair(rng, (2, 6, 4, 32))
    kj, kt = _pair(rng, (2, 11, 2, 32))
    vj, vt = _pair(rng, (2, 11, 2, 32))
    if masked:
        m = rng.random((1, 6, 11)) < 0.7
        m[..., 0] = True
        mt, mj = torch.as_tensor(m), jnp.asarray(m)
    else:
        mt = mj = None
    _close(attn.full_attention(qt, kt, vt, mt),
           ref_attn.full_attention(qj, kj, vj, mj))


@pytest.mark.parametrize("impl,s", [("chunked", 40), ("chunked", 150),
                                    ("pallas", 150)])
def test_attention_train_forward_matches_reference(impl, s):
    cfg = _attn_cfg()
    p_ref, p = _attn_params(cfg, 6)
    xj, xt = _pair(np.random.default_rng(7), (2, s, cfg.d_model))
    pos = np.arange(s)
    _close(attn.attention_train(p, xt, cfg, torch.as_tensor(pos),
                                attn_impl=impl),
           ref_attn.attention_train(p_ref, xj, cfg, jnp.asarray(pos),
                                    attn_impl=impl))


@pytest.mark.parametrize("window,s", [(None, 40), (None, 150), (24, 40),
                                      (24, 150), (200, 150)])
def test_prefill_then_decode_match_reference(window, s):
    """attention_prefill (both branches; ring-buffer cache when windowed)
    and 8 attention_decode steps from its cache, GQA 2:1."""
    cfg = _attn_cfg(qkv_bias=True, window=window)
    p_ref, p = _attn_params(cfg, 8)
    rng = np.random.default_rng(9)
    xj, xt = _pair(rng, (2, s, cfg.d_model))
    pos = np.arange(s)
    out, cache = attn.attention_prefill(p, xt, cfg, torch.as_tensor(pos),
                                        window=window)
    out_ref, cache_ref = ref_attn.attention_prefill(
        p_ref, xj, cfg, jnp.asarray(pos), window=window)
    _close(out, out_ref)
    for n in ("k", "v"):
        _close(cache[n], cache_ref[n])
    # Continue in full-length caches, as the serving path restages them.
    total = s + DECODE_STEPS
    full = attn.init_kv_cache(cfg, 2, total, window=window)
    full_ref = ref_attn.init_kv_cache(cfg, 2, total, window=window)
    for n in ("k", "v"):
        pre = cache[n]
        full[n][:, :pre.shape[1]] = pre
        full_ref[n] = full_ref[n].at[:, :pre.shape[1]].set(cache_ref[n])
    for i in range(DECODE_STEPS):
        yj, yt = _pair(rng, (2, 1, cfg.d_model))
        o, full = attn.attention_decode(p, yt, full, s + i, cfg, window=window)
        o_ref, full_ref = ref_attn.attention_decode(
            p_ref, yj, full_ref, jnp.int32(s + i), cfg, window=window)
        _close(o, o_ref)
    for n in ("k", "v"):
        _close(full[n], full_ref[n])


# ---------------------------------------------------------------------- #
# Whole models
# ---------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _reference_model(arch, n_layers=None):
    """(reference bundle, reference params as numpy) for reduced ``arch``
    in fp32 (``n_layers`` deep if given); qkv biases and the recurrent
    blocks' gate biases, ``dt_bias`` and ``D`` drawn anew so that they
    matter."""
    cfg = _fp32(ref_configs.get_config(arch), n_layers)
    bundle = ref_build_model(cfg)
    params = jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(10)
    for blk in params["stack"]["blocks"] + params["stack"]["extras"]:
        for n in ("bq", "bk", "bv", "b_a", "b_i", "dt_bias", "D"):
            if n in blk["temporal"]:
                t = blk["temporal"][n]
                blk["temporal"][n] = rng.normal(size=t.shape).astype(t.dtype)
    return bundle, params


@functools.lru_cache(maxsize=None)
def _reference_run(arch, prompt_len, n_layers=None):
    """The reference's prefill of a ``demo_batch`` prompt, then greedy
    decode in a restaged full-length cache: (prefill cache, logits of each
    step (B, 1 + DECODE_STEPS, V), tokens). A VLM's ``prompt_len``
    positions are its patch prefix and its text, as in the reference demo."""
    bundle, params = _reference_model(arch, n_layers)
    cfg = bundle.cfg
    params = jax.tree.map(jnp.asarray, params)
    batch = demo_batch(get_config(arch).reduced(), "prefill", B, prompt_len,
                       seed=prompt_len)
    pre, logits = jax.jit(bundle.prefill)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    cache = jax.tree.map(
        lambda f, p: f.at[tuple(slice(0, s) for s in p.shape)].set(p),
        ref_make_cache(cfg, B, prompt_len + DECODE_STEPS + 1), pre)
    decode = jax.jit(bundle.decode_step)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    all_logits, toks = [logits], [tok]
    for i in range(DECODE_STEPS):
        cache, logits = decode(params, cache, tok, jnp.int32(prompt_len + i))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        all_logits.append(logits)
        toks.append(tok)
    return (jax.tree.map(np.asarray, pre), np.stack(all_logits, axis=1),
            np.concatenate(toks, axis=1), batch)


def _port(arch, n_layers=None):
    cfg = _fp32(get_config(arch), n_layers)
    bundle = build_model(cfg, device="cpu")
    _, ref_params = _reference_model(arch, n_layers)
    return bundle, params_from_reference(ref_params, cfg, "cpu")


@REF_MOE_WARNING
@pytest.mark.parametrize("prompt_len", [33, 160])
@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_reduced_model_serving_matches_reference(arch, prompt_len):
    """Prefill logits and caches, then 8 greedy decode steps through
    ``generate``: logits within 1e-4 of the reference's largest at every
    step, the same tokens. 33 tokens take the plain attention branch, 160
    (> attn_chunk = 64) the chunked one."""
    pre_ref, logits_ref, toks_ref, batch = _reference_run(arch, prompt_len)
    bundle, params = _port(arch)
    pre, logits = bundle.prefill(params, batch)
    assert _rel(logits.numpy(), logits_ref[:, 0]) < 1e-4
    for got, want in zip(tree_leaves(pre), jax.tree.leaves(pre_ref)):
        _close(got, want, 1e-4)
    out = serve.generate(bundle, params, batch, DECODE_STEPS + 1)
    assert out.logits.shape == logits_ref.shape
    assert _rel(out.logits.numpy(), logits_ref) < 1e-4
    assert np.array_equal(out.tokens.numpy(), toks_ref)


@pytest.mark.parametrize("prompt_len", [33, 160])
def test_recurrentgemma_with_trailing_layers_matches_reference(prompt_len):
    """Reduced recurrentgemma-2b at 8 layers: (rglru, rglru, lattn) × 2
    stacked + 2 trailing rglru layers with their own params and caches, as
    at full width (26 = 3 × 8 + 2). Prefill logits and caches, then 8
    greedy decode steps: within 1e-4 of the reference's largest, the same
    tokens."""
    pre_ref, logits_ref, toks_ref, batch = _reference_run(
        "recurrentgemma-2b", prompt_len, 8)
    bundle, params = _port("recurrentgemma-2b", 8)
    assert len(params["stack"]["extras"]) == 2
    pre, logits = bundle.prefill(params, batch)
    assert _rel(logits.numpy(), logits_ref[:, 0]) < 1e-4
    for got, want in zip(tree_leaves(pre), jax.tree.leaves(pre_ref)):
        _close(got, want, 1e-4)
    out = serve.generate(bundle, params, batch, DECODE_STEPS + 1)
    assert _rel(out.logits.numpy(), logits_ref) < 1e-4
    assert np.array_equal(out.tokens.numpy(), toks_ref)


@pytest.mark.parametrize("arch,n_layers", [("mamba2-370m", None),
                                           ("recurrentgemma-2b", 8)])
def test_decode_updates_the_stacked_cache_in_place(arch, n_layers):
    """``decode_step`` hands every layer views of the stacked cache and
    keeps none of what the layers return, so each recurrent layer must
    write its new conv and state into those views. After a prefill, a
    restage and 3 decode steps every cache leaf equals the reference's
    returned cache after the same steps; a layer that rebinds its cache
    dict's entries leaves the prompt's state in the stack and fails
    here."""
    bundle, params = _port(arch, n_layers)
    ref_bundle, ref_params = _reference_model(arch, n_layers)
    ref_params = jax.tree.map(jnp.asarray, ref_params)
    batch = demo_batch(bundle.cfg, "prefill", B, 20, seed=5)
    total = 20 + 3
    pre, logits = bundle.prefill(params, batch)
    cache = make_cache(bundle.cfg, B, total, device="cpu")
    for full, p in zip(tree_leaves(cache), tree_leaves(pre)):
        full[tuple(slice(0, s) for s in p.shape)] = p
    pre_ref, logits_ref = jax.jit(ref_bundle.prefill)(
        ref_params, {"tokens": jnp.asarray(batch["tokens"])})
    cache_ref = jax.tree.map(
        lambda f, p: f.at[tuple(slice(0, s) for s in p.shape)].set(p),
        ref_make_cache(ref_bundle.cfg, B, total), pre_ref)
    before = [t.clone() for t in tree_leaves(cache)]
    tok = np.array(jnp.argmax(logits_ref, -1))[:, None]
    for i in range(3):
        cache, _ = bundle.decode_step(params, cache, torch.as_tensor(tok),
                                      20 + i)
        cache_ref, logits_ref = jax.jit(ref_bundle.decode_step)(
            ref_params, cache_ref, jnp.asarray(tok, jnp.int32),
            jnp.int32(20 + i))
        tok = np.array(jnp.argmax(logits_ref, -1))[:, None]
    leaves, leaves_ref = tree_leaves(cache), jax.tree.leaves(cache_ref)
    assert len(leaves) == len(leaves_ref)
    for got, want, old in zip(leaves, leaves_ref, before):
        assert not torch.equal(got, old)
        _close(got, want, 1e-4)


@REF_MOE_WARNING
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "llama4-scout-17b-a16e"])
def test_moe_decode_at_batch_2_drops_over_capacity(arch, monkeypatch):
    """Decode at batch 2 routes 2 tokens a layer, so each expert holds
    ``max(int(2·k/4·1.25), 1) = 1`` of them: where both tokens pick one
    expert, the later choice is dropped. The port drops the reference's
    choices: the same logits and tokens, and some decode step dropped."""
    from repro_torch.models import moe

    routed = []
    real = moe.route

    def route_spy(router, xt, cfg):
        r = real(router, xt, cfg)
        routed.append((xt.shape[0], r.capacity, int((~r.keep).sum())))
        return r

    _, logits_ref, toks_ref, batch = _reference_run(arch, 33)
    bundle, params = _port(arch)
    monkeypatch.setattr(moe, "route", route_spy)
    out = serve.generate(bundle, params, batch, DECODE_STEPS + 1)
    decode = [(c, n) for t, c, n in routed if t == B]
    assert len(decode) == DECODE_STEPS * bundle.cfg.n_layers
    assert {c for c, _ in decode} == {1}
    assert sum(n for _, n in decode) > 0
    assert _rel(out.logits.numpy(), logits_ref) < 1e-4
    assert np.array_equal(out.tokens.numpy(), toks_ref)


def test_params_from_reference_carries_a_bf16_moe_with_its_fp32_router():
    """A reduced bf16 deepseek-moe-16b crosses leaf for leaf in the
    reference's dtypes (bf16, the routers fp32); any other leaf that is not
    in ``param_dtype`` is still refused."""
    arch = "deepseek-moe-16b"
    cfg = get_config(arch).reduced()
    ref = jax.tree.map(np.asarray, ref_build_model(
        ref_configs.get_config(arch).reduced()).init(jax.random.PRNGKey(1)))
    carried = params_from_reference(ref, cfg, "cpu")
    got, want = tree_leaves(carried), jax.tree.leaves(ref)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        assert np.array_equal(g.float().numpy(), w.astype(np.float32))
    routers = [blk["ffn"]["router"] for blk in carried["stack"]["blocks"]]
    assert routers and {r.dtype for r in routers} == {torch.float32}
    assert {t.dtype for t in got} == {torch.bfloat16, torch.float32}
    ffn = ref["stack"]["blocks"][0]["ffn"]
    ffn["w_up"] = ffn["w_up"].astype(np.float32)
    with pytest.raises(ValueError, match="w_up"):
        params_from_reference(ref, cfg, "cpu")


@pytest.mark.parametrize("arch,fp32_names", [
    ("recurrentgemma-2b", {"b_a", "b_i", "lam"}),
    ("mamba2-370m", {"A_log", "D", "dt_bias"})])
def test_params_from_reference_carries_the_recurrent_fp32_leaves(arch,
                                                                 fp32_names):
    """A reduced bf16 recurrentgemma-2b (at 8 layers, trailing layers
    included) or mamba2-370m crosses leaf for leaf in the reference's
    dtypes: bf16, and fp32 for its recurrent blocks' fp32 leaves only. An
    fp32 leaf of another name, or one of those names in a layer of another
    kind, is refused, naming the leaf."""
    cfg = get_config(arch).reduced()
    ref_cfg = ref_configs.get_config(arch).reduced()
    if arch == "recurrentgemma-2b":
        cfg = dataclasses.replace(cfg, n_layers=8)
        ref_cfg = dataclasses.replace(ref_cfg, n_layers=8)
    ref = jax.tree.map(np.asarray,
                       ref_build_model(ref_cfg).init(jax.random.PRNGKey(1)))
    carried = params_from_reference(ref, cfg, "cpu")
    got, want = tree_leaves(carried), jax.tree.leaves(ref)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        assert np.array_equal(g.float().numpy(), w.astype(np.float32))
    layers_ = carried["stack"]["blocks"] + carried["stack"]["extras"]
    fp32 = {n for blk in layers_ for n, t in blk["temporal"].items()
            if t.dtype == torch.float32}
    assert fp32 == fp32_names
    temporal = ref["stack"]["blocks"][0]["temporal"]
    stray = "w_a" if arch == "recurrentgemma-2b" else "w_in"
    temporal[stray] = temporal[stray].astype(np.float32)
    with pytest.raises(ValueError, match=stray):
        params_from_reference(ref, cfg, "cpu")
    temporal[stray] = temporal[stray].astype(want[0].dtype)
    if arch == "recurrentgemma-2b":  # "lam" is fp32 in rglru layers only
        attn_layer = ref["stack"]["blocks"][2]["temporal"]
        attn_layer["lam"] = np.zeros((2, 4), np.float32)
        with pytest.raises(ValueError, match="lam"):
            params_from_reference(ref, cfg, "cpu")


def _smoke_module():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("arch", sorted(PORTED))
def test_full_width_params_match_reference_eval_shape(arch):
    """Every served arch at full width and depth, built on the meta
    device: the parameter tree's shapes and dtypes equal
    ``jax.eval_shape`` of the reference's init, leaf for leaf."""
    mine = build_model(get_config(arch), device="meta").init(
        torch.Generator().manual_seed(0))
    ref = jax.eval_shape(ref_build_model(ref_configs.get_config(arch)).init,
                         jax.random.PRNGKey(0))
    assert [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for t in tree_leaves(mine)] == [
        (tuple(a.shape), str(a.dtype)) for a in jax.tree.leaves(ref)]


def test_smoke_param_table_is_the_reference_init_count():
    """``chip_smoke.EXACT_PARAMS`` (the card run's exact parameter count of
    each arch it serves) equals the count of ``jax.eval_shape`` of the
    reference's init: ``cfg.n_params()`` is an analytic approximation,
    exact for glm4-9b and deepseek-moe-16b only."""
    table = _smoke_module().EXACT_PARAMS
    assert set(table) >= set(RECURRENT_ARCHS)
    for arch, count in table.items():
        ref = jax.eval_shape(
            ref_build_model(ref_configs.get_config(arch)).init,
            jax.random.PRNGKey(0))
        assert count == sum(int(np.prod(a.shape))
                            for a in jax.tree.leaves(ref)), arch


@REF_MOE_WARNING
@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_greedy_tokens_match_decode_demo(arch, monkeypatch):
    """``repro_torch.launch.serve.main`` and ``examples/decode_demo.py``
    with the same flags and the demo's own weights (its seeded init,
    carried across) give the same greedy tokens. Both run in fp32."""
    real = ref_configs.get_config
    monkeypatch.setattr(ref_configs, "get_config", lambda name: dataclasses.replace(
        real(name), param_dtype="float32"))
    spec = importlib.util.spec_from_file_location(
        "decode_demo", os.path.join(REPO, "examples", "decode_demo.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "70",
            "--gen-len", "6", "--seed", "3"]
    want = demo.main(argv)

    cfg = _fp32(get_config(arch))
    ref_params = ref_build_model(_fp32(real(arch))).init(jax.random.PRNGKey(3))
    bundle = build_model(cfg, device="cpu")
    params = params_from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                                   "cpu")
    got = serve.generate(bundle, params,
                         demo_batch(cfg, "prefill", 2, 70, seed=3), 6)
    assert np.array_equal(got.tokens.numpy(), want)


@pytest.mark.parametrize("arch", ["glm4-9b", "stablelm-1.6b"]
                         + RECURRENT_ARCHS)
def test_prefill_decode_consistency(arch):
    """prefill(t_1..t_n) logits == incremental decode of the same tokens
    (the port's own counterpart of tests/test_models.py's check)."""
    cfg = _fp32(get_config(arch))
    bundle = build_model(cfg, device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    toks = torch.as_tensor(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (B, 33)))
    _, logits_pre = bundle.prefill(params, {"tokens": toks})
    cache = make_cache(cfg, B, 33, device="cpu")
    for pos in range(33):
        cache, logits = bundle.decode_step(params, cache, toks[:, pos:pos + 1],
                                           pos)
    assert _rel(logits.numpy(), logits_pre.numpy()) < 1e-4


def test_generate_samples_with_temperature_reproducibly():
    cfg = get_config("glm4-9b").reduced()
    bundle = build_model(cfg, device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    batch = demo_batch(cfg, "prefill", 2, 12, seed=0)
    runs = [serve.generate(bundle, params, batch, 5, temperature=1.0,
                           generator=torch.Generator().manual_seed(7))
            for _ in range(2)]
    assert torch.equal(runs[0].tokens, runs[1].tokens)
    assert runs[0].tokens.shape == (2, 5)
    assert int(runs[0].tokens.max()) < cfg.vocab_size


def test_serve_main_on_host_and_without_gpu(monkeypatch, capsys):
    before = flash_attention_cuda.launches
    gen = serve.main(["--arch", "glm4-9b", "--reduced", "--batch", "2",
                      "--prompt-len", "80", "--gen-len", "4",
                      "--device", "cpu"])
    assert gen.shape == (2, 4)
    assert "prefill 2x80" in capsys.readouterr().out
    # The host route never launches the kernel.
    assert flash_attention_cuda.launches == before
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "glm4-9b", "--reduced"])


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "llama4-scout-17b-a16e"])
def test_serve_main_serves_moe_on_host_and_without_gpu(arch, monkeypatch,
                                                       capsys):
    gen = serve.main(["--arch", arch, "--reduced", "--batch", "2",
                      "--prompt-len", "40", "--gen-len", "4",
                      "--device", "cpu"])
    assert gen.shape == (2, 4)
    assert "prefill 2x40" in capsys.readouterr().out
    build_model(get_config(arch), device="cpu")  # full width builds
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", arch, "--reduced"])


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_serve_main_serves_recurrent_archs_on_host_and_without_gpu(
        arch, monkeypatch, capsys):
    gen = serve.main(["--arch", arch, "--reduced", "--batch", "2",
                      "--prompt-len", "40", "--gen-len", "4",
                      "--device", "cpu"])
    assert gen.shape == (2, 4)
    assert "prefill 2x40" in capsys.readouterr().out
    build_model(get_config(arch), device="cpu")  # full width builds
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", arch, "--reduced"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_config(arch))


def test_every_registered_arch_is_served():
    """The registry has no arch the port refuses: ``build_model`` builds
    each at full width (on the meta device) and reduced on the host."""
    assert PORTED == set(list_archs())
    for arch in list_archs():
        build_model(get_config(arch), device="meta")
        build_model(get_config(arch).reduced(), device="cpu")
