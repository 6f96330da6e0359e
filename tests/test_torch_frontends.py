"""The port's modality frontends against the JAX package's, on the CPU.

hubert-xlarge (an encoder over precomputed audio frames, bidirectional
attention, no decode) and internvl2-2b (a decoder whose prompt is a prefix
of precomputed ViT patch embeddings, then text): ``embed_batch``'s three
branches, the encoder's "prefill" (one encoder forward: its last-position
logits and the KV cache tree the reference builds), and the VLM's serving
path, whose prompt length counts the patches. Reduced configs in fp32 with
the reference's init carried across; internvl2-2b's prefill, decode and
greedy tokens against ``examples/decode_demo.py`` and both archs' full-width
parameter trees are in ``tests/test_torch_models.py`` (``MODEL_ARCHS`` /
``PORTED``). Tolerances: 1e-5 for the frontend projection (one fp32
product), 1e-4 of the largest value for a whole model.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.configs as ref_configs  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro_torch.configs import demo_batch, get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import (  # noqa: E402
    build_model,
    make_cache,
    params_from_reference,
)
from repro_torch.models.transformer import tree_leaves  # noqa: E402

B = 2


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _reference(arch):
    cfg = dataclasses.replace(ref_configs.get_config(arch).reduced(),
                              param_dtype="float32")
    bundle = ref_build_model(cfg)
    return bundle, jax.tree.map(np.asarray,
                                bundle.init(jax.random.PRNGKey(0)))


def _port(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="float32")
    bundle = build_model(cfg, device="cpu")
    return bundle, params_from_reference(_reference(arch)[1], cfg, "cpu")


@pytest.mark.parametrize("arch", ["hubert-xlarge", "internvl2-2b",
                                  "stablelm-1.6b"])
def test_embed_batch_matches_reference(arch):
    """Audio frames through ``frontend_proj``; patches through it, ahead of
    the token embeddings, with a loss mask of zeros under the patches and
    ones under the text; tokens alone, no mask. Against the reference's
    ``embed_batch`` formulas on its own params."""
    bundle, params = _port(arch)
    _, ref = _reference(arch)
    batch = demo_batch(bundle.cfg, "train", B, 40, seed=4)
    x, mask = bundle.embed_batch(params, batch)
    if "frames" in batch:
        want, want_mask = jnp.asarray(batch["frames"]) @ ref["frontend_proj"], None
    elif "patches" in batch:
        xv = jnp.asarray(batch["patches"]) @ ref["frontend_proj"]
        xt = jnp.take(ref["embed"], batch["tokens"], axis=0)
        want = jnp.concatenate([xv, xt], axis=1)
        want_mask = np.concatenate([np.zeros(xv.shape[:2]),
                                    np.ones(xt.shape[:2])], axis=1)
    else:
        want, want_mask = jnp.take(ref["embed"], batch["tokens"], axis=0), None
    assert tuple(x.shape) == (B, 40, bundle.cfg.d_model)
    np.testing.assert_allclose(x.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if want_mask is None:
        assert mask is None
    else:
        assert mask.dtype == torch.float32
        np.testing.assert_array_equal(mask.numpy(), want_mask)


def test_frontend_projection_is_drawn_in_the_param_dtype():
    """``init`` draws ``frontend_proj`` (frontend_dim, d_model) on the
    device in ``param_dtype``, N(0, 1) · frontend_dim ** -0.5."""
    cfg = get_config("internvl2-2b").reduced()
    p = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    w = p["frontend_proj"]
    assert tuple(w.shape) == (cfg.frontend_dim, cfg.d_model)
    assert w.dtype == torch.bfloat16
    assert abs(float(w.float().std()) * cfg.frontend_dim ** 0.5 - 1) < 0.1


@pytest.mark.parametrize("frames", [33, 160])
def test_encoder_prefill_matches_reference(frames):
    """hubert-xlarge's "prefill" is one encoder forward: the last frame's
    logits and every layer's KV cache against the reference's, 33 frames
    (plain attention) and 160 (> attn_chunk = 64: the chunked scan),
    bidirectional both ways."""
    bundle, params = _port("hubert-xlarge")
    ref_bundle, ref = _reference("hubert-xlarge")
    batch = demo_batch(bundle.cfg, "prefill", B, frames, seed=frames)
    assert sorted(batch) == ["frames"]
    cache, logits = bundle.prefill(params, batch)
    cache_ref, logits_ref = jax.jit(ref_bundle.prefill)(
        jax.tree.map(jnp.asarray, ref), {"frames": jnp.asarray(batch["frames"])})
    assert logits.shape == (B, bundle.cfg.vocab_size)
    assert _rel(logits.numpy(), logits_ref) < 1e-4
    leaves, leaves_ref = tree_leaves(cache), jax.tree.leaves(cache_ref)
    assert [tuple(t.shape) for t in leaves] == [a.shape for a in leaves_ref]
    for got, want in zip(leaves, leaves_ref):
        assert _rel(got.numpy(), want) < 1e-4


def test_encoder_attends_both_ways():
    """Changing the last frame moves the first frame's output in the
    encoder (bidirectional); the same stack as a decoder (causal) keeps it
    bit for bit. 20 frames (plain attention) and 80 (the chunked scan)."""
    from repro_torch.models.transformer import stack_train

    bundle, params = _port("hubert-xlarge")
    for s in (20, 80):
        x, _ = bundle.embed_batch(
            params, demo_batch(bundle.cfg, "prefill", 1, s, seed=1))
        x2 = x.clone()
        x2[:, -1] += 1.0
        pos = torch.arange(s)
        for decoder in (False, True):
            cfg = dataclasses.replace(bundle.cfg, decoder=decoder)
            h, _ = stack_train(params["stack"], x, cfg, pos)
            h2, _ = stack_train(params["stack"], x2, cfg, pos)
            assert torch.equal(h[:, 0], h2[:, 0]) == decoder


@pytest.mark.parametrize("prompt_len", [40, 160])
def test_vlm_decode_continues_after_the_patches(prompt_len):
    """The VLM's prompt is patches + text: ``generate`` sizes the cache and
    numbers the decode positions from both. Each decode step's logits equal
    the last-position logits of one prefill over the patches, the text and
    the tokens generated so far (1e-4 of the largest)."""
    bundle, params = _port("internvl2-2b")
    batch = demo_batch(bundle.cfg, "prefill", B, prompt_len, seed=7)
    n_patch = batch["patches"].shape[1]
    assert n_patch + batch["tokens"].shape[1] == prompt_len
    assert serve.prompt_length(batch) == prompt_len
    out = serve.generate(bundle, params, batch, 4)
    for i in range(1, 4):
        longer = dict(batch, tokens=np.concatenate(
            [batch["tokens"], out.tokens[:, :i].numpy()], axis=1))
        _, want = bundle.prefill(params, longer)
        assert _rel(out.logits[:, i].numpy(), want.numpy()) < 1e-4
    cache = make_cache(bundle.cfg, B, prompt_len + 4, device="cpu")
    assert cache["blocks"][0]["k"].shape[2] == prompt_len + 4


def test_serve_main_serves_the_vlm_and_exits_for_the_encoder(monkeypatch,
                                                              capsys):
    gen = serve.main(["--arch", "internvl2-2b", "--reduced", "--batch", "2",
                      "--prompt-len", "40", "--gen-len", "4",
                      "--device", "cpu"])
    assert gen.shape == (2, 4)
    assert "prefill 2x40" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "hubert-xlarge", "--reduced", "--device",
                    "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("internvl2-2b", "hubert-xlarge"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(get_config(arch))
