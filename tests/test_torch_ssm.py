"""The port's Mamba-2 SSD block (``repro_torch.models.ssm``) and causal
depthwise conv against the JAX package's.

Numpy-seeded inputs and the reference's own init of a reduced mamba2-370m
(d_model 64, 8 heads of 16, state 16, ``ssm_chunk`` 16; layer 0, carried
across with ``params_from_reference``, ``dt_bias`` and ``D`` redrawn so that
they matter) go through ``repro.models`` and ``repro_torch.models`` on the
CPU. Tolerances: fp32 1e-5 (one op chain, summed in another order: the
port batches the chunks' einsums where the reference scans them). bf16:
rtol 1e-2 plus 1e-2 of the largest output, :data:`BF16_TOL`. Both sides
round the same intermediates to bf16 (the conv, the SiLU, ``x·dt``, the SSD
output), but XLA may keep a fused chain in fp32 and the matmuls sum in
another order, so one intermediate may land one bf16 step (2^-8 to 2^-7 of
its value) away and carry that into the output: 1e-2 is about 2.5 bf16
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
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import params_from_reference, ssm  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.transformer import tree_map  # noqa: E402

ARCH = "mamba2-370m"
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


def _cfgs(dtype="float32"):
    return (dataclasses.replace(get_config(ARCH).reduced(), param_dtype=dtype),
            dataclasses.replace(ref_configs.get_config(ARCH).reduced(),
                                param_dtype=dtype))


def _layer(dtype="float32", seed=0):
    """(port cfg, ref cfg, layer 0's temporal params: port, reference)."""
    cfg, ref_cfg = _cfgs(dtype)
    tree = jax.tree.map(np.asarray, ref_build_model(ref_cfg).init(
        jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    temporal = tree["stack"]["blocks"][0]["temporal"]
    for n in ("dt_bias", "D"):
        temporal[n] = rng.normal(size=temporal[n].shape).astype(np.float32)
    carried = params_from_reference(tree, cfg, "cpu")
    p = tree_map(lambda t: t[0], carried["stack"]["blocks"][0]["temporal"])
    p_ref = jax.tree.map(lambda a: jnp.asarray(a[0]), temporal)
    return cfg, ref_cfg, p, p_ref


# ---------------------------------------------------------------------- #
# causal_depthwise_conv
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 5, 33])
def test_causal_depthwise_conv_matches_reference(s, with_state):
    rng = np.random.default_rng(s)
    xj, xt = _pair(rng, (B, s, 24))
    wj, wt = _pair(rng, (4, 24), 0.3)
    sj, st_ = _pair(rng, (B, 3, 24)) if with_state else (None, None)
    y, state = layers.causal_depthwise_conv(xt, wt, st_)
    y_ref, state_ref = ref_layers.causal_depthwise_conv(xj, wj, sj)
    _close(y, y_ref)
    _close(state, state_ref)


def test_causal_depthwise_conv_bf16_matches_reference():
    rng = np.random.default_rng(7)
    xj, xt = _pair(rng, (B, 33, 24), dtype="bfloat16")
    wj, wt = _pair(rng, (4, 24), 0.3, dtype="bfloat16")
    sj, st_ = _pair(rng, (B, 3, 24), dtype="bfloat16")
    y, state = layers.causal_depthwise_conv(xt, wt, st_)
    y_ref, state_ref = ref_layers.causal_depthwise_conv(xj, wj, sj)
    assert y.dtype == state.dtype == torch.bfloat16
    _close_bf16(y, y_ref)
    # The state is a copy of inputs: exact.
    assert np.array_equal(state.float().numpy(),
                          np.asarray(state_ref, np.float32))


# ---------------------------------------------------------------------- #
# ssd_chunked
# ---------------------------------------------------------------------- #
def _ssd_inputs(rng, s, h=4, p=8, n=6):
    xj, xt = _pair(rng, (B, s, h, p))
    a = -np.abs(rng.normal(size=(B, s, h))).astype(np.float32) * 0.5
    bj, bt = _pair(rng, (B, s, n))
    cj, ct = _pair(rng, (B, s, n))
    return (xj, jnp.asarray(a), bj, cj), (xt, torch.as_tensor(a), bt, ct)


@pytest.mark.parametrize("s", [1, 16, 33, 64, 100])
def test_ssd_chunked_matches_reference(s):
    """Whole chunks and ragged tails (S = 1, 33, 100 are padded to 16s)."""
    ref_in, mine = _ssd_inputs(np.random.default_rng(s), s)
    _close(ssm.ssd_chunked(*mine, 16), ref_ssm.ssd_chunked(*ref_in, 16))


@settings(deadline=None, max_examples=12)
@given(s=st.integers(1, 80), chunk=st.sampled_from([4, 8, 16]),
       seed=st.integers(0, 1000))
def test_ssd_chunked_property_over_s(s, chunk, seed):
    ref_in, mine = _ssd_inputs(np.random.default_rng(seed), s, h=2, p=4, n=3)
    _close(ssm.ssd_chunked(*mine, chunk), ref_ssm.ssd_chunked(*ref_in, chunk))


# ---------------------------------------------------------------------- #
# The block: prefill and decode
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("s", [33, 64])
def test_apply_ssm_train_matches_reference(s):
    cfg, ref_cfg, p, p_ref = _layer()
    uj, ut = _pair(np.random.default_rng(s), (B, s, cfg.d_model))
    _close(ssm.apply_ssm_train(p, ut, cfg),
           ref_ssm.apply_ssm_train(p_ref, uj, ref_cfg))


def _prefill_then_decode(dtype, s=33):
    """The port's and the reference's ``_ssm_prefill`` over ``s`` tokens,
    then DECODE_STEPS decode steps from its caches: ((out, cache, step
    outputs, final cache) port, the same reference)."""
    cfg, ref_cfg, p, p_ref = _layer(dtype)
    rng = np.random.default_rng(11)
    uj, ut = _pair(rng, (B, s, cfg.d_model), dtype=dtype)
    out, cache = transformer._ssm_prefill(p, ut, cfg)
    out_ref, cache_ref = ref_transformer._ssm_prefill(p_ref, uj, ref_cfg)
    prefill = (out, {k: v.clone() for k, v in cache.items()},
               out_ref, cache_ref)
    steps, steps_ref = [], []
    tensors = dict(cache)
    for _ in range(DECODE_STEPS):
        yj, yt = _pair(rng, (B, 1, cfg.d_model), dtype=dtype)
        o, returned = ssm.apply_ssm_decode(p, yt, cache, cfg)
        # Written in place: the same tensors come back.
        assert returned is cache
        assert all(cache[k] is tensors[k] for k in tensors)
        o_ref, cache_ref = ref_ssm.apply_ssm_decode(p_ref, yj, cache_ref,
                                                    ref_cfg)
        steps.append(o)
        steps_ref.append(o_ref)
    return prefill, (steps, cache, steps_ref, cache_ref)


def test_ssm_prefill_and_decode_match_reference():
    """``_ssm_prefill``'s output and (conv, state) caches at S = 33 (not a
    multiple of the chunk), then 8 decode steps from them: outputs and the
    caches the port updated in place."""
    (out, cache, out_ref, cache_ref), decode = _prefill_then_decode("float32")
    _close(out, out_ref)
    for n in ("conv", "state"):
        _close(cache[n], cache_ref[n])
    steps, cache, steps_ref, cache_ref = decode
    for o, o_ref in zip(steps, steps_ref):
        _close(o, o_ref)
    for n in ("conv", "state"):
        _close(cache[n], cache_ref[n])


def test_ssm_bf16_matches_reference():
    """A bf16 layer (its ``A_log``/``D``/``dt_bias`` fp32): prefill output,
    caches and 8 decode steps within :data:`BF16_TOL`."""
    (out, cache, out_ref, cache_ref), decode = _prefill_then_decode("bfloat16")
    assert cache["conv"].dtype == torch.bfloat16
    assert cache["state"].dtype == torch.float32
    _close_bf16(out, out_ref)
    for n in ("conv", "state"):
        _close_bf16(cache[n], cache_ref[n])
    steps, cache, steps_ref, cache_ref = decode
    for o, o_ref in zip(steps, steps_ref):
        _close_bf16(o, o_ref)
    _close_bf16(cache["state"], cache_ref["state"])
