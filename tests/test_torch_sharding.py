"""The port's sharding rules (``repro_torch.launch.sharding``) against the
JAX package's (``repro.launch.sharding``), entry by entry, and the cut of a
parameter tree into model shards (``repro_torch.models.parallel``).

The reference runs in one subprocess on ``jax.sharding.AbstractMesh``es and
``jax.eval_shape`` trees (nothing is allocated): every registry arch at full
width, its parameter, ZeRO-1 moment, decode-cache and batch specs on the
meshes (16, 16), (2, 16, 16), (2, 2), (1, 4) and (4, 1). The port's trees
come from the meta device. The round trip ``shard_params`` ->
``unshard_params`` runs on gloo ranks (2 and 4 shards) and must return
every leaf bitwise.
"""

import dataclasses
import functools
import json
import os

import pytest

torch = pytest.importorskip("torch")

from conftest import run_with_devices  # noqa: E402

from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.configs.shapes import batch_schema  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.launch.mesh import MeshSpec  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.parallel import (  # noqa: E402
    ModelShards,
    model_dims,
    shard_params,
    unshard_params,
)
from repro_torch.models.transformer import init_cache, tree_leaves  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "4x1": ((4, 1), ("data", "model"))}
# (kind, batch, seq) of the batch specs; the decode cache's (batch, length).
BATCHES = (("train", 256, 4096), ("prefill", 32, 32768), ("decode", 128, 1))
CACHE = (128, 32768)

_REFERENCE = r"""
import json
import jax
from jax.sharding import AbstractMesh
import repro.configs as rc
from repro.configs.shapes import batch_schema, cache_specs
from repro.launch import sharding as shr
from repro.models import build_model

def spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in tuple(s.spec)]

out = {}
for arch in rc.list_archs():
    cfg = rc.get_config(arch)
    shapes = jax.eval_shape(build_model(cfg).init, jax.random.PRNGKey(0))
    cache = cache_specs(cfg, *CACHE)
    for name, (shape, axes) in MESHES.items():
        mesh = AbstractMesh(tuple(shape), tuple(axes))
        ps = shr.param_shardings(shapes, cfg, mesh)
        opt = shr.opt_shardings(ps, mesh, shapes)
        batches = {}
        for kind, b, s in BATCHES:
            schema = batch_schema(cfg, kind, b, s)
            specs = {k: jax.ShapeDtypeStruct(shp, dt)
                     for k, (shp, dt) in schema.items()}
            batches[kind] = {k: spec(v) for k, v in
                             shr.batch_shardings(specs, mesh).items()}
        out[arch + "/" + name] = {
            "params": [spec(s) for s in jax.tree.leaves(ps)],
            "m": [spec(s) for s in jax.tree.leaves(opt["m"])],
            "count": spec(opt["count"]),
            "cache": [spec(s) for s in jax.tree.leaves(
                shr.cache_shardings(cache, cfg, mesh))],
            "batch": batches}
print("JSON" + json.dumps(out))
"""


def _plain(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


@pytest.fixture(scope="module")
def reference():
    code = (f"MESHES = {MESHES!r}\nBATCHES = {BATCHES!r}\nCACHE = {CACHE!r}\n"
            + _REFERENCE)
    out = run_with_devices(code, n_devices=1)
    return json.loads(out.split("JSON", 1)[1])


@functools.lru_cache(maxsize=None)
def _meta(arch):
    cfg = get_config(arch)
    params = build_model(cfg, device="meta").init(
        torch.Generator().manual_seed(0))
    return cfg, params, init_cache(cfg, *CACHE, device="meta")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_specs_equal_the_reference(arch, mesh, reference):
    """Parameter, ZeRO-1 moment, optimizer count, decode-cache and batch
    specs of every leaf, in leaf order, on each mesh."""
    want = reference[f"{arch}/{mesh}"]
    cfg, params, cache = _meta(arch)
    m = MeshSpec(*MESHES[mesh])
    ps = sharding.param_shardings(params, cfg, m)
    assert [_plain(s) for s in sharding.leaves(ps)] == want["params"]
    opt = sharding.opt_shardings(ps, m, params)
    assert [_plain(s) for s in sharding.leaves(opt["m"])] == want["m"]
    assert opt["m"] is opt["v"] and _plain(opt["count"]) == want["count"]
    assert [_plain(s) for s in sharding.leaves(
        sharding.cache_shardings(cache, cfg, m))] == want["cache"]
    for kind, b, s in BATCHES:
        specs = {k: torch.empty(shp, device="meta")
                 for k, (shp, _) in batch_schema(cfg, kind, b, s).items()}
        got = sharding.batch_shardings(specs, m)
        assert {k: _plain(v) for k, v in got.items()} == want["batch"][kind]


def test_model_dims_follow_the_model_entries():
    """glm4-9b over 4 shards: the vocabulary, the q/k/v columns (k and v
    through a head: 2 x 128 over 4), the MLP's hidden dim and wo's rows
    are cut; the norms are whole. Over 1 shard nothing is."""
    cfg = get_config("glm4-9b")
    _, params, _ = _meta("glm4-9b")
    keys = []
    sharding.map_with_path(lambda p, t: keys.append(sharding.keystr(p)),
                           params)
    dims = dict(zip(keys, model_dims(cfg, 4)))
    layer = "['stack']['blocks'][0]"
    assert dims["['embed']"] == 0 and dims["['unembed']"] == 1
    for w in ("wq", "wk", "wv"):
        assert dims[f"{layer}['temporal']['{w}']"] == 2
    assert dims[f"{layer}['temporal']['wo']"] == 1
    assert dims[f"{layer}['ffn']['w_gate']"] == 2
    assert dims[f"{layer}['ffn']['w_down']"] == 1
    assert dims[f"{layer}['norm1']['scale']"] is None
    assert dims["['final_norm']['scale']"] is None
    assert set(model_dims(cfg, 1)) == {None}


def _round_trip_job(rank, world, store, out_dir):
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        pair = torch.distributed.new_group([0, 1])
        res = {}
        for arch in list_archs():
            cfg = dataclasses.replace(get_config(arch).reduced(),
                                      train_mode="usec")
            full = build_model(cfg, device="cpu").init(
                torch.Generator().manual_seed(0))
            for n, group in ((2, pair), (4, None)):
                if n == 2 and rank >= 2:
                    continue
                tp = ModelShards(group, n, rank)
                local = shard_params(full, cfg, n, rank)
                back = unshard_params(local, cfg, tp)
                cut = sum(a.shape != b.shape for a, b in zip(
                    tree_leaves(local), tree_leaves(full)))
                same = all(a.dtype == b.dtype and torch.equal(a, b)
                           for a, b in zip(tree_leaves(back),
                                           tree_leaves(full)))
                res[f"{arch}/{n}"] = (same, cut)
        with open(os.path.join(out_dir, f"trip{rank}.json"), "w") as fh:
            json.dump(res, fh)
    finally:
        torch.distributed.destroy_process_group()


def test_shard_then_unshard_is_the_tree_bitwise(tmp_path):
    """Every arch's reduced tree (in usec mode, so every rule cuts): each
    rank's cut, gathered over 2 and over 4 gloo ranks, is the whole tree
    bit for bit; some leaves were cut."""
    tmp = str(tmp_path)
    torch.multiprocessing.start_processes(
        _round_trip_job, args=(4, os.path.join(tmp, "store"), tmp),
        nprocs=4, start_method="spawn")
    for r in range(4):
        with open(os.path.join(tmp, f"trip{r}.json")) as fh:
            res = json.load(fh)
        assert len(res) == len(list_archs()) * (2 if r < 2 else 1)
        for key, (same, cut) in res.items():
            assert same and cut > 0, key
