"""The port's RG-LRU block (``repro_torch.models.rglru``) against the JAX
package's.

Numpy-seeded inputs and the reference's own init of a reduced
recurrentgemma-2b (d_model 64 = D_rnn; layer 0, carried across with
``params_from_reference``, ``b_a``/``b_i`` redrawn so that they matter) go
through ``repro.models`` and ``repro_torch.models`` on the CPU. The port's
log-depth scan (:func:`~repro_torch.models.rglru.linear_scan`, Hillis–Steele)
is held against ``jax.lax.associative_scan`` with the reference's
``_assoc``. Tolerances: fp32 1e-5 (the two scans combine the pairs in
another order). bf16: rtol 1e-2 plus 1e-2 of the largest output,
:data:`BF16_TOL`: both sides round the same intermediates to bf16 (the in
projections, the conv, ``h·gate``, the out projection), but XLA may keep a
fused chain in fp32 and the matmuls sum in another order, so one may land
one bf16 step (2^-8 to 2^-7 of its value) away: 1e-2 is about 2.5 bf16
ulps of the largest value.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from _hypothesis_compat import given, settings, strategies as st  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import rglru as ref_rglru  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import params_from_reference, rglru  # noqa: E402
from repro_torch.models.transformer import tree_map  # noqa: E402

ARCH = "recurrentgemma-2b"
TOL = 1e-5
BF16_TOL = (1e-2, 1e-2)  # (rtol, atol as a share of the largest |output|)
B, DECODE_STEPS = 2, 8


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _close_bf16(got, want):
    got = np.asarray(torch.as_tensor(got).float(), np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    rtol, share = BF16_TOL
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=share * np.abs(want).max())


def _pair(rng, shape, scale=1.0, dtype="float32"):
    a = (rng.normal(size=shape) * scale).astype(np.float32)
    return (jnp.asarray(a, dtype),
            torch.as_tensor(a).to(getattr(torch, dtype)))


def _layer(dtype="float32", seed=0):
    """(port cfg, ref cfg, layer 0's temporal params: port, reference)."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), param_dtype=dtype)
    ref_cfg = dataclasses.replace(ref_configs.get_config(ARCH).reduced(),
                                  param_dtype=dtype)
    tree = jax.tree.map(np.asarray, ref_build_model(ref_cfg).init(
        jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    temporal = tree["stack"]["blocks"][0]["temporal"]
    for n in ("b_a", "b_i"):
        temporal[n] = rng.normal(size=temporal[n].shape).astype(np.float32)
    carried = params_from_reference(tree, cfg, "cpu")
    p = tree_map(lambda t: t[0], carried["stack"]["blocks"][0]["temporal"])
    p_ref = jax.tree.map(lambda a: jnp.asarray(a[0]), temporal)
    return cfg, ref_cfg, p, p_ref


# ---------------------------------------------------------------------- #
# The scan
# ---------------------------------------------------------------------- #
def _scan_inputs(rng, s, width=40):
    """Decays over the whole range the block gives, exp(-8·softplus(0.55)
    ·r) for r in (0, 1): about 3.3e-4 to 1."""
    r = rng.random((B, s, width))
    a = np.exp(-8.0 * np.log1p(np.exp(0.55)) * r).astype(np.float32)
    b = rng.normal(size=(B, s, width)).astype(np.float32)
    return a, b


@jax.jit
def _ref_scan(a, b):
    return jax.lax.associative_scan(ref_rglru._assoc, (a, b), axis=1)[1]


def _check_scan(a, b):
    want = _ref_scan(jnp.asarray(a), jnp.asarray(b))
    _close(rglru.linear_scan(torch.as_tensor(a), torch.as_tensor(b)), want)


@pytest.mark.parametrize("s", [1, 2, 3, 127, 1000])
def test_linear_scan_matches_associative_scan(s):
    _check_scan(*_scan_inputs(np.random.default_rng(s), s))


@settings(deadline=None, max_examples=12)
@given(s=st.integers(1, 300), seed=st.integers(0, 1000))
def test_linear_scan_property_over_s(s, seed):
    _check_scan(*_scan_inputs(np.random.default_rng(seed), s, width=8))


def test_linear_scan_survives_decays_that_underflow():
    """Decays at the floor for 2000 steps: their running product
    underflows fp32 (3.3e-4^12 < 1e-38), which a scan that divides by it
    would turn into inf/nan. The port's is finite and equal to the
    reference's."""
    a = np.full((1, 2000, 4), 3.3e-4, np.float32)
    b = np.random.default_rng(0).normal(size=(1, 2000, 4)).astype(np.float32)
    h = rglru.linear_scan(torch.as_tensor(a), torch.as_tensor(b))
    assert bool(torch.isfinite(h).all())
    _check_scan(a, b)


# ---------------------------------------------------------------------- #
# The block: prefill and decode
# ---------------------------------------------------------------------- #
def test_gates_match_reference():
    _, _, p, p_ref = _layer()
    xj, xt = _pair(np.random.default_rng(3), (B, 17, 64))
    for got, want in zip(rglru._gates(p, xt), ref_rglru._gates(p_ref, xj)):
        _close(got, want)


@pytest.mark.parametrize("s", [1, 33, 100])
def test_apply_rglru_train_matches_reference(s):
    cfg, ref_cfg, p, p_ref = _layer()
    uj, ut = _pair(np.random.default_rng(s), (B, s, cfg.d_model))
    _close(rglru.apply_rglru_train(p, ut, cfg),
           jax.jit(ref_rglru.apply_rglru_train, static_argnums=2)(
               p_ref, uj, ref_cfg))


def _prefill_then_decode(dtype, s=33):
    """The port's ``rglru_prefill`` against the reference's
    ``apply_rglru_train`` + ``_rglru_state_from_prefill`` over ``s``
    tokens, then DECODE_STEPS decode steps from the caches."""
    cfg, ref_cfg, p, p_ref = _layer(dtype)
    rng = np.random.default_rng(12)
    uj, ut = _pair(rng, (B, s, cfg.d_model), dtype=dtype)
    out, cache = rglru.rglru_prefill(p, ut, cfg)
    out_ref = jax.jit(ref_rglru.apply_rglru_train, static_argnums=2)(
        p_ref, uj, ref_cfg)
    cache_ref = jax.jit(ref_transformer._rglru_state_from_prefill,
                        static_argnums=2)(p_ref, uj, ref_cfg)
    # Decode continues in a fresh cache, as the serving path restages it.
    full = rglru.init_rglru_cache(cfg, B)
    for n in full:
        full[n].copy_(cache[n])
    prefill = (out, {k: v.clone() for k, v in cache.items()},
               out_ref, cache_ref)
    steps, steps_ref = [], []
    tensors = dict(full)
    for _ in range(DECODE_STEPS):
        yj, yt = _pair(rng, (B, 1, cfg.d_model), dtype=dtype)
        o, returned = rglru.apply_rglru_decode(p, yt, full, cfg)
        # Written in place: the same tensors come back.
        assert returned is full
        assert all(full[k] is tensors[k] for k in tensors)
        o_ref, cache_ref = ref_rglru.apply_rglru_decode(p_ref, yj, cache_ref,
                                                        ref_cfg)
        steps.append(o)
        steps_ref.append(o_ref)
    return prefill, (steps, full, steps_ref, cache_ref)


def test_rglru_prefill_and_decode_match_reference():
    """The prefill's output and (conv, h) cache against
    ``_rglru_state_from_prefill``, then 8 decode steps: outputs and the
    cache the port updated in place."""
    (out, cache, out_ref, cache_ref), decode = _prefill_then_decode("float32")
    _close(out, out_ref)
    for n in ("conv", "h"):
        _close(cache[n], cache_ref[n])
    steps, cache, steps_ref, cache_ref = decode
    for o, o_ref in zip(steps, steps_ref):
        _close(o, o_ref)
    for n in ("conv", "h"):
        _close(cache[n], cache_ref[n])


def test_rglru_bf16_matches_reference():
    """A bf16 layer (its ``b_a``/``b_i``/``lam`` fp32): prefill output,
    cache and 8 decode steps within :data:`BF16_TOL`."""
    (out, cache, out_ref, cache_ref), decode = _prefill_then_decode("bfloat16")
    assert out.dtype == cache["conv"].dtype == torch.bfloat16
    assert cache["h"].dtype == torch.float32
    _close_bf16(out, out_ref)
    for n in ("conv", "h"):
        _close_bf16(cache[n], cache_ref[n])
    steps, cache, steps_ref, cache_ref = decode
    for o, o_ref in zip(steps, steps_ref):
        _close_bf16(o, o_ref)
    _close_bf16(cache["h"], cache_ref["h"])
