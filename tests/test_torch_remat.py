"""The reference's remat policies in the port's layer stack.

``stack_train`` recomputes activations in the backward by one of three
policies (``src/repro/models/transformer.py``): per-block checkpoints
(``cfg.remat``), per-sublayer checkpoints that keep the sublayer outputs
(``remat_save_outs``, the reference's default), and two-level checkpoints
over groups of ``_inner_factor(n_repeats)`` blocks (``remat_sqrt``). None
changes a value: the loss and every gradient are bitwise those without
remat, on a dense, an MoE and a recurrent reduced arch in fp32. The
policies' structure is checked by counting the checkpoints and the
temporal sublayers' forwards (each runs twice under any policy).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import demo_batch, get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.transformer import tree_leaves  # noqa: E402
from repro_torch.runtime.trainstep import value_and_grad  # noqa: E402

POLICIES = {
    "none": {"remat": False},
    "remat": {"remat": True, "remat_save_outs": False, "remat_sqrt": False},
    "save_outs": {"remat": True, "remat_save_outs": True,
                  "remat_sqrt": False},
    "sqrt": {"remat": True, "remat_save_outs": False, "remat_sqrt": True},
    # sqrt takes precedence over save_outs when it forms groups.
    "sqrt_and_save_outs": {"remat": True, "remat_save_outs": True,
                           "remat_sqrt": True},
}
# (arch, layers): 4 pattern blocks each, so remat_sqrt forms 2 groups of 2.
ARCHS = [("stablelm-1.6b", 4), ("deepseek-moe-16b", 4),
         ("recurrentgemma-2b", 12)]


def _cfg(arch, layers, **policy):
    return dataclasses.replace(get_config(arch).reduced(), n_layers=layers,
                               param_dtype="float32", **policy)


def _run(cfg, params, batch, monkeypatch):
    """(loss, gradients, checkpoints taken, temporal forwards run)."""
    counts = {"checkpoint": 0, "temporal": 0}
    real_ckpt, real_temporal = transformer.checkpoint, \
        transformer._temporal_train

    def ckpt(*args, **kwargs):
        counts["checkpoint"] += 1
        return real_ckpt(*args, **kwargs)

    def temporal(*args, **kwargs):
        counts["temporal"] += 1
        return real_temporal(*args, **kwargs)

    with monkeypatch.context() as m:
        m.setattr(transformer, "checkpoint", ckpt)
        m.setattr(transformer, "_temporal_train", temporal)
        loss, _, grads = value_and_grad(
            build_model(cfg, device="cpu").loss_fn, params, batch)
    return loss, grads, counts


@pytest.mark.parametrize("arch,layers", ARCHS)
def test_remat_policies_change_no_value(arch, layers, monkeypatch):
    base = _cfg(arch, layers)
    params = build_model(base, device="cpu").init(
        torch.Generator().manual_seed(0))
    batch = demo_batch(base, "train", 2, 96, seed=3)
    n_rep, _ = transformer.stack_layout(base)
    plen = len(base.layer_pattern)
    sublayers = sum(1 if k == "ssm" else 2 for k in base.layer_pattern)
    want_ckpt = {"none": 0, "remat": n_rep, "save_outs": n_rep * sublayers,
                 "sqrt": n_rep // 2, "sqrt_and_save_outs": n_rep // 2}
    runs = {name: _run(_cfg(arch, layers, **pol), params, batch, monkeypatch)
            for name, pol in POLICIES.items()}
    loss0, grads0, _ = runs["none"]
    for name, (loss, grads, counts) in runs.items():
        assert torch.equal(loss, loss0), name
        assert len(grads) == len(tree_leaves(params))
        for a, b in zip(grads, grads0):
            assert torch.equal(a, b), name
        assert counts["checkpoint"] == want_ckpt[name], (name, counts)
        # Every layer's temporal sublayer runs once, and once again in the
        # backward under any policy.
        assert counts["temporal"] == (1 if name == "none" else 2) * (
            n_rep * plen), (name, counts)


def test_inner_factor_matches_the_reference():
    ref = pytest.importorskip("repro.models.transformer")
    got = [transformer._inner_factor(n) for n in range(1, 101)]
    assert got == [ref._inner_factor(n) for n in range(1, 101)]
    assert transformer._inner_factor(24) == 4  # internvl2-2b: 6 groups of 4


def test_sqrt_without_groups_falls_back_like_the_reference(monkeypatch):
    """With fewer than 4 blocks ``_inner_factor`` is 1 and remat_sqrt does
    nothing of its own: the reference then takes remat_save_outs when set,
    else per-block remat."""
    cfg = _cfg("stablelm-1.6b", 3, remat=True, remat_sqrt=True,
               remat_save_outs=True)
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(1))
    batch = demo_batch(cfg, "train", 1, 40, seed=1)
    _, _, counts = _run(cfg, params, batch, monkeypatch)
    assert counts["checkpoint"] == 3 * 2
    cfg = dataclasses.replace(cfg, remat_save_outs=False)
    _, _, counts = _run(cfg, params, batch, monkeypatch)
    assert counts["checkpoint"] == 3
