"""Serving over model shards: ``prefill``, ``decode_step`` and
``launch.serve.generate`` with weights cut by the sharding rules and decode
caches cut by ``cache_shardings``, on gloo ranks on the CPU, against the
one-process port and against the JAX package's GSPMD-sharded serving.

Reduced fp32 configs of every decoder family (dense glm4-9b, MoE
deepseek-moe-16b and llama4-scout, rglru + lattn recurrentgemma-2b, ssm
mamba2-370m, the VLM internvl2-2b) and hubert-xlarge's encoder prefill,
the pure-DP archs with the usec rules (as the reference's dry-run serves
them), on meshes M 2, M 4 and D 2 x M 2, a batch of B rows:

* the prefill's last logits and STEPS teacher-forced decode steps' logits
  within 1e-5 of the one-process run (of the largest |logit|), each data
  index serving its own rows; the greedy tokens of ``generate`` equal;
* every rank's cache leaves (after the prefill, and after the decode steps
  in the full-length cache) equal ``shard_cache`` of the one-process
  cache within 1e-5, and ``unshard_cache`` gathers the whole one (prompts whose caches the rule cuts on slots, heads
  and head dims, and restages that move slots between ranks: ``CASES``);
* at 2 x 2 and 1 x 4, the logits within 1e-4 of the reference's
  ``bundle.prefill`` and ``decode_step`` jitted with ``param_shardings``
  and ``cache_shardings`` on 4 forced host devices (same numpy weights,
  ``params_from_reference``, same tokens), and each rank's cache cut equal
  to the reference's ``addressable_shards`` on the device at its mesh
  coordinates within 1e-4.

The streamed init (``bundle.init`` over the groups) is bitwise
``shard_params`` of the whole init at M 2, M 4 and D 2 x M 2 with chunks
that span layer boundaries, and its setup peak on meta tensors (the
dry-run's storage tracker) is at most the resting bytes plus one chunk.

The ranks are spawned processes meeting in a file store under the test's
temporary directory, one thread each; the reference runs in one
subprocess, overlapped with them.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import REPO, SRC  # noqa: E402

from repro_torch.configs import demo_batch, get_config  # noqa: E402
from repro_torch.launch.serve import generate, restage  # noqa: E402
from repro_torch.models import (  # noqa: E402
    build_model,
    make_cache,
    params_from_reference,
)
from repro_torch.models.parallel import (  # noqa: E402
    DataShards,
    ModelShards,
    gather_dim,
    over,
    own_rows,
    shard_cache,
    shard_params,
    unshard_cache,
)
from repro_torch.models.transformer import tree_leaves  # noqa: E402

TOL, REF_TOL = 1e-5, 1e-4
B, PROMPT, STEPS = 2, 72, 8
ARCHS = ("glm4-9b", "deepseek-moe-16b", "llama4-scout-17b-a16e",
         "recurrentgemma-2b", "mamba2-370m", "internvl2-2b", "hubert-xlarge")
# (arch, prompt positions); the full cache holds prompt + STEPS. Every arch
# at PROMPT (> attn_chunk: the chunked attention; 72 and 80 slots, both cut
# on slots, so the restage moves slots between ranks); glm4-9b also at 12
# (at M 4 a head-dim cut restaged into a slot cut) and 13 (21 slots: the
# decode over a head cut at M 2, a head-dim cut at M 4).
CASES = [(a, PROMPT) for a in ARCHS] + [("glm4-9b", 12), ("glm4-9b", 13)]
MESHES = {"m2": (1, 2), "m4": (1, 4), "d2m2": (2, 2)}
REF_MESHES = ("m4", "d2m2")


def _cfg(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="float32")
    if cfg.train_mode == "dp":  # serving takes the usec layout
        cfg = dataclasses.replace(cfg, train_mode="usec")
    return cfg


def _key(arch, prompt):
    return f"{arch}@{prompt}"


def _batch(arch, prompt):
    return demo_batch(_cfg(arch), "prefill", B, prompt, seed=prompt)


def _rel(got, want) -> float:
    got = np.asarray(torch.as_tensor(got).double())
    want = np.asarray(torch.as_tensor(want).double())
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else float(
        np.abs(got).max())


def _whole_vocab(lg, cfg, tp):
    return gather_dim(lg, tp, -1) if over(tp, lg.shape[-1], cfg.vocab_size) \
        else lg


def serve_case(arch, prompt, ref_params, tokens, shards=None, data=None):
    """One case on this process (whole) or over the groups: the prefill's
    cache leaves and last logits (this rank's rows, whole vocabulary), the
    teacher-forced decode's logits (``tokens``, the whole batch's) and
    final cache leaves, ``generate``'s greedy tokens and the rows served."""
    cfg = _cfg(arch)
    batch = _batch(arch, prompt)
    bundle = build_model(cfg, device="cpu", shards=shards, data=data)
    params = params_from_reference(ref_params, cfg, "cpu", shards, data)
    moved = [] if shards is None else [shards.stats["bytes"]]
    with torch.no_grad():
        pre, logits = bundle.prefill(params, batch)
        moved += [] if shards is None else [shards.stats["bytes"]]
        out = {"pre": [t.clone() for t in tree_leaves(pre)],
               "logits": [_whole_vocab(logits, cfg, shards)]}
        rows = own_rows(B, data)
        out["rows"] = None if rows is None else [rows.start, rows.stop]
        if not cfg.decoder:
            out["model_bytes"] = moved
            return out
        length = prompt + STEPS
        cache = make_cache(cfg, B, length, "cpu", shards, data)
        restage(cache, pre, cfg, B, prompt, length, shards)
        for i in range(STEPS):
            before = None if shards is None else shards.stats["bytes"]
            cache, lg = bundle.decode_step(
                params, cache, torch.as_tensor(tokens[:, i:i + 1]),
                prompt + i, cache_len=length)
            if shards is not None:
                moved.append(shards.stats["bytes"] - before)
            out["logits"].append(_whole_vocab(lg, cfg, shards))
        out["cache"] = tree_leaves(cache)
        out["model_bytes"] = moved
        if shards is not None:
            out["whole_cache"] = tree_leaves(unshard_cache(
                cache, cfg, B, length, shards, data))
        out["greedy"] = generate(bundle, params, batch, STEPS).tokens
    return out


def _rank_job(rank, world, store, out_dir, params_path):
    import torch.distributed as dist

    from repro_torch.launch.mesh import (
        coordinates,
        data_group,
        make_worker_mesh,
        model_group,
    )

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        with open(params_path, "rb") as fh:
            ref = pickle.load(fh)
        pair = dist.new_group([0, 1])
        res = {}
        for name, (n_data, n_model) in MESHES.items():
            if n_data * n_model == 4:
                mesh = make_worker_mesh(n_data, n_model, device_type="cpu")
                d, m = coordinates(mesh)
                shards = ModelShards(model_group(mesh), n_model, m)
                data = (DataShards(data_group(mesh), n_data, d)
                        if n_data > 1 else None)
            elif rank < 2:
                shards, data = ModelShards(pair, 2, rank), None
            else:
                continue
            for arch, prompt in CASES:
                key = _key(arch, prompt)
                res[(name, key)] = serve_case(
                    arch, prompt, ref["params"][arch], ref["tokens"][key],
                    shards, data)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


_REFERENCE = r"""
import dataclasses, pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs import demo_batch, get_config
from repro.configs.shapes import cache_specs
from repro.launch import sharding as shr
from repro.launch.mesh import make_worker_mesh
from repro.models import build_model, make_cache

OUT, CASES, MESHES, B, STEPS = {out!r}, {cases!r}, {meshes!r}, {b}, {steps}
ARCHS = sorted(set(a for a, _ in CASES))


def cfg_of(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="float32")
    if cfg.train_mode == "dp":
        cfg = dataclasses.replace(cfg, train_mode="usec")
    return cfg


rng = np.random.default_rng(10)
params = {{}}
for arch in ARCHS:
    p = jax.tree.map(np.asarray,
                     build_model(cfg_of(arch)).init(jax.random.PRNGKey(1)))
    for blk in p["stack"]["blocks"] + p["stack"]["extras"]:
        if blk is None:
            continue
        for n in ("bq", "bk", "bv", "b_a", "b_i", "dt_bias", "D"):
            if n in blk["temporal"]:
                t = blk["temporal"][n]
                blk["temporal"][n] = rng.normal(size=t.shape).astype(t.dtype)
    params[arch] = p

# One device: the greedy tokens every run is teacher-forced with.
tokens = {{}}
for arch, prompt in CASES:
    cfg = cfg_of(arch)
    bundle = build_model(cfg)
    batch = demo_batch(cfg, "prefill", B, prompt, seed=prompt)
    key = f"{{arch}}@{{prompt}}"
    if not cfg.decoder:
        tokens[key] = np.zeros((B, STEPS), np.int64)
        continue
    pr = jax.tree.map(jnp.asarray, params[arch])
    pre, lg = jax.jit(bundle.prefill)(pr, batch)
    cache = jax.tree.map(
        lambda f, p: f.at[tuple(slice(0, s) for s in p.shape)].set(p),
        make_cache(cfg, B, prompt + STEPS), pre)
    tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
    toks = [tok]
    decode = jax.jit(bundle.decode_step)
    for i in range(STEPS - 1):
        cache, lg = decode(pr, cache, tok, jnp.int32(prompt + i))
        tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
        toks.append(tok)
    tokens[key] = np.asarray(jnp.concatenate(toks, 1)).astype(np.int64)
with open(OUT + "/params.pkl", "wb") as fh:
    pickle.dump({{"params": params, "tokens": tokens}}, fh)
print("PARAMS", flush=True)


def shards_of(tree, mesh):
    # [leaf][d * M + m]: each device's shard, by its mesh coordinates
    devs = mesh.devices
    out = []
    for leaf in jax.tree.leaves(tree):
        by_dev = {{s.device: np.asarray(s.data) for s in leaf.addressable_shards}}
        out.append([by_dev[devs[d, m]] for d in range(devs.shape[0])
                    for m in range(devs.shape[1])])
    return out


res = {{}}
for name, (n_data, n_model) in MESHES.items():
    mesh = make_worker_mesh(n_data, n_model)
    dp = shr.dp_axes(mesh)
    for arch, prompt in CASES:
        cfg = cfg_of(arch)
        bundle = build_model(cfg)
        key = f"{{arch}}@{{prompt}}"
        pshard = shr.param_shardings(params[arch], cfg, mesh)
        pr = jax.device_put(jax.tree.map(jnp.asarray, params[arch]), pshard)
        batch = demo_batch(cfg, "prefill", B, prompt, seed=prompt)
        bsh = shr.batch_shardings(
            {{k: jax.ShapeDtypeStruct(v.shape, v.dtype)
              for k, v in batch.items()}}, mesh)
        batch = {{k: jax.device_put(v, bsh[k]) for k, v in batch.items()}}
        lsh = shr.guarded(mesh, (B, cfg.vocab_size), dp, "model")
        pre_sh = shr.cache_shardings(cache_specs(cfg, B, prompt), cfg, mesh)
        pre, lg = jax.jit(bundle.prefill, out_shardings=(pre_sh, lsh))(
            pr, batch)
        rec = {{"pre": shards_of(pre, mesh), "logits": [np.asarray(lg)]}}
        if cfg.decoder:
            n = prompt + STEPS
            full_sh = shr.cache_shardings(cache_specs(cfg, B, n), cfg, mesh)
            cache = jax.jit(lambda p: jax.tree.map(
                lambda f, q: f.at[tuple(slice(0, s) for s in q.shape)].set(q),
                make_cache(cfg, B, n), p), out_shardings=full_sh)(pre)
            decode = jax.jit(bundle.decode_step,
                             out_shardings=(full_sh, lsh))
            toks = tokens[key]
            for i in range(STEPS):
                tok = jax.device_put(
                    jnp.asarray(toks[:, i:i + 1], jnp.int32),
                    shr.guarded(mesh, (B, 1), dp))
                cache, lg = decode(pr, cache, tok, jnp.int32(prompt + i))
                rec["logits"].append(np.asarray(lg))
            rec["cache"] = shards_of(cache, mesh)
        res[(name, key)] = rec
with open(OUT + "/reference.pkl", "wb") as fh:
    pickle.dump(res, fh)
print("DONE", flush=True)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's weights, tokens and sharded runs (one subprocess),
    the 4 gloo ranks and the one-process runs, overlapped."""
    tmp = str(tmp_path_factory.mktemp("serve_tp"))
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get(
        "PYTHONPATH", ""),
        XLA_FLAGS="--xla_force_host_platform_device_count=4")
    code = _REFERENCE.format(out=tmp, cases=CASES, b=B, steps=STEPS,
                             meshes={k: MESHES[k] for k in REF_MESHES})
    ref = subprocess.Popen([sys.executable, "-c", code],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=env, cwd=REPO)
    path = os.path.join(tmp, "params.pkl")
    t0 = time.time()
    while not os.path.exists(os.path.join(tmp, "reference.pkl")) and \
            ref.poll() is None and time.time() - t0 < 300:
        if os.path.exists(path):
            break
        time.sleep(0.2)
    time.sleep(0.5)  # the pickle is written before the line is printed
    if not os.path.exists(path):
        out, err = ref.communicate(timeout=60)
        raise AssertionError(err[-4000:])
    torch.multiprocessing.start_processes(
        _rank_job, args=(4, os.path.join(tmp, "store"), tmp, path),
        nprocs=4, start_method="spawn")
    with open(path, "rb") as fh:
        weights = pickle.load(fh)
    one = {_key(a, p): serve_case(a, p, weights["params"][a],
                                  weights["tokens"][_key(a, p)])
           for a, p in CASES}
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(4)]
    out, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-4000:]
    with open(os.path.join(tmp, "reference.pkl"), "rb") as fh:
        reference = pickle.load(fh)
    return {"one": one, "ranks": ranks, "ref": reference,
            "tokens": weights["tokens"]}


def _mesh_ranks(name):
    n_data, n_model = MESHES[name]
    return [(r, r // n_model, r % n_model) for r in range(n_data * n_model)]


PAIRS = [(name, a, p) for name in MESHES for a, p in CASES]


def _ids(x):
    return x if isinstance(x, str) else str(x)


@pytest.mark.parametrize("mesh,arch,prompt", PAIRS, ids=_ids)
def test_logits_equal_the_one_process_run(mesh, arch, prompt, runs):
    key = _key(arch, prompt)
    one = runs["one"][key]
    for r, d, _ in _mesh_ranks(mesh):
        got = runs["ranks"][r][(mesh, key)]
        rows = slice(*got["rows"]) if got["rows"] else slice(None)
        assert len(got["logits"]) == len(one["logits"])
        for step, (a, b) in enumerate(zip(got["logits"], one["logits"])):
            assert a.shape == b[rows].shape
            assert _rel(a, b[rows]) <= TOL, (r, step)


@pytest.mark.parametrize("mesh,arch,prompt", PAIRS, ids=_ids)
def test_cache_cuts_equal_shard_cache(mesh, arch, prompt, runs):
    key = _key(arch, prompt)
    one = runs["one"][key]
    cfg = _cfg(arch)
    n_data, n_model = MESHES[mesh]
    whole = {"pre": one["pre"]}
    if "cache" in one:
        whole["cache"] = one["cache"]
    for r, d, m in _mesh_ranks(mesh):
        got = runs["ranks"][r][(mesh, key)]
        for kind, leaves in whole.items():
            want = tree_leaves(shard_cache(_tree(cfg, leaves, kind, prompt),
                                           cfg, n_model, m, n_data, d))
            assert len(got[kind]) == len(want)
            for a, b in zip(got[kind], want):
                assert a.shape == b.shape, (r, kind)
                assert _rel(a, b) <= TOL, (r, kind)
        if "cache" in one:  # every rank's cut gathered whole
            for a, b in zip(got["whole_cache"], one["cache"], strict=True):
                assert a.shape == b.shape and _rel(a, b) <= TOL, r


def _tree(cfg, leaves, kind, prompt):
    from repro_torch.models.transformer import init_cache, tree_unflatten

    n = prompt if kind == "pre" else prompt + STEPS
    return tree_unflatten(init_cache(cfg, B, n, device="meta"), leaves)


@pytest.mark.parametrize("mesh,arch,prompt", [
    pair for pair in PAIRS if _cfg(pair[1]).decoder], ids=_ids)
def test_greedy_tokens_equal(mesh, arch, prompt, runs):
    want = runs["one"][_key(arch, prompt)]["greedy"]
    for r, _, _ in _mesh_ranks(mesh):
        assert torch.equal(runs["ranks"][r][(mesh, _key(arch, prompt))]
                           ["greedy"], want)


@pytest.mark.parametrize("arch", ARCHS)
def test_data_ranks_serve_their_rows(arch, runs):
    key = _key(arch, PROMPT)
    for r, d, _ in _mesh_ranks("d2m2"):
        got = runs["ranks"][r][("d2m2", key)]
        assert got["rows"] == [d * B // 2, (d + 1) * B // 2]
        assert all(lg.shape[0] == B // 2 for lg in got["logits"])


@pytest.mark.parametrize("mesh,arch,prompt", [
    (name, a, p) for name in REF_MESHES for a, p in CASES], ids=_ids)
def test_equal_the_reference_sharded_serving(mesh, arch, prompt, runs):
    key = _key(arch, prompt)
    ref = runs["ref"][(mesh, key)]
    for r, d, m in _mesh_ranks(mesh):
        got = runs["ranks"][r][(mesh, key)]
        rows = slice(*got["rows"]) if got["rows"] else slice(None)
        for a, b in zip(got["logits"], ref["logits"]):
            assert _rel(a, b[rows]) <= REF_TOL, r
        for kind in ("pre", "cache"):
            if kind not in ref:
                continue
            assert len(got[kind]) == len(ref[kind])
            for a, b in zip(got[kind], ref[kind]):
                assert tuple(a.shape) == b[r].shape, (r, kind)
                assert _rel(a, b[r]) <= REF_TOL, (r, kind)


@pytest.mark.parametrize("mesh,arch", [(m, a) for m in ("m4", "d2m2")
                                       for a in ARCHS])
def test_model_bytes_equal_the_dryrun_trace(mesh, arch, runs):
    """Each rank's model-group bytes in the prefill and in each decode
    step (the layers' ``stats``) equal ``launch.dryrun.trace_serve``'s of
    the same cell on a fake group of the mesh's shape (rank 0)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshSpec

    spec = MeshSpec(MESHES[mesh], ("data", "model"))
    cfg = _cfg(arch)
    want = []
    for kind, seq in (("prefill", PROMPT), ("decode", PROMPT + STEPS)):
        if kind == "decode" and not cfg.decoder:
            continue
        res = dryrun.trace_serve(cfg, kind, B, seq, spec)
        want.append(res["cost"].groups[res["group_names"]["model"]]["bytes"])
    for r, _, _ in _mesh_ranks(mesh):
        moved = runs["ranks"][r][(mesh, _key(arch, PROMPT))]["model_bytes"]
        prefill = moved[1] - moved[0]
        assert prefill == want[0] > 0
        if cfg.decoder:
            assert moved[2:] == [want[1]] * STEPS


def test_one_process_tokens_equal_the_reference(runs):
    for a, p in CASES:
        if _cfg(a).decoder:
            key = _key(a, p)
            assert np.array_equal(runs["one"][key]["greedy"],
                                  runs["tokens"][key])


# ---------------------------------------------------------------------- #
# The streamed init
# ---------------------------------------------------------------------- #
INIT_MESHES = [(2, 1), (4, 1), (2, 2)]


@pytest.mark.parametrize("n_model,n_data", INIT_MESHES)
@pytest.mark.parametrize("arch", ARCHS + ("qwen1.5-110b",))
def test_streamed_init_is_the_whole_init_cut(arch, n_model, n_data,
                                             monkeypatch):
    """Bitwise, with chunks of 1024 elements: every chunk of a stacked
    leaf spans layers and cut boundaries. qwen1.5-110b and llama4-scout
    are fsdp archs: their leaves are cut over data too."""
    from repro_torch.models import layers

    monkeypatch.setattr(layers, "_INIT_CHUNK", 1 << 10)
    cfg = dataclasses.replace(get_config(arch).reduced(), train_mode=(
        "usec" if get_config(arch).train_mode == "dp"
        else get_config(arch).train_mode))
    whole = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(5))
    for m in range(n_model):
        for d in range(n_data):
            data = DataShards(None, n_data, d) if n_data > 1 else None
            got = build_model(cfg, device="cpu",
                              shards=ModelShards(None, n_model, m),
                              data=data).init(
                torch.Generator().manual_seed(5))
            want = shard_params(whole, cfg, n_model, m, n_data, d)
            for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
                assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch,n_model,n_data", [
    ("qwen1.5-110b", 4, 1), ("llama4-scout-17b-a16e", 4, 1),
    ("qwen1.5-110b", 2, 2)])
def test_streamed_init_peak_is_the_cut_plus_one_chunk(arch, n_model, n_data):
    """At full width (2 layers), on meta tensors: the largest live total
    while ``init`` runs is at most this rank's resting bytes plus one fp32
    chunk of ``normal_`` (a whole stacked leaf is far larger)."""
    from repro_torch.launch.op_cost import MemoryTracker, traced
    from repro_torch.models.layers import _INIT_CHUNK

    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    data = DataShards(None, n_data, 0) if n_data > 1 else None
    bundle = build_model(cfg, device="meta",
                         shards=ModelShards(None, n_model, 0), data=data)
    mem = MemoryTracker()
    with traced(mem) as setup:
        params = bundle.init(torch.Generator().manual_seed(0))
    resting = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    biggest = max(t.numel() * t.element_size() * n_model * n_data
                  for t in tree_leaves(params))
    assert biggest > 4 * _INIT_CHUNK * 4
    assert resting <= setup.cost.peak_bytes <= resting + 4 * _INIT_CHUNK
