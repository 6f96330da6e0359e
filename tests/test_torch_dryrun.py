"""The port's dry-run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``) and against the steps it traces.

* For every (arch, shape, mesh) cell, ``build_cell``'s meta equals the
  reference's (computed in a subprocess with ``REPRO_DRYRUN_DEVICES=512``):
  the skip reasons, ``G``, ``tile_samples``, ``t_stage``, ``b_max``,
  ``n_micro``, ``avg_trips``, ``n_params``, ``n_active_params``; the
  model flops follow; rank 0's parameter shapes in every train cell equal
  the reference's ``NamedSharding.shard_shape``, serving cells too, and a
  serving cell's rank-0 decode cache leaves the reference's
  ``cache_shardings`` shard shapes; every cell's ``act_shard_axis`` and
  ``act_batch_axes`` the config the reference's ``build_cell`` builds its
  model with (the sequence-parallel residual stream on in the fsdp train
  cells); ``micro_batch_size`` equals the reference's integer for
  integer.
* A 2 x 2 reduced usec step with ZeRO-1 and a reduced fsdp step run for
  real on 4 gloo ranks: each rank's data-group and model-group bytes (the
  layers' and the step's ``stats``) equal the dry-run's trace of the same
  step on a fake 2 x 2 group.
* Twin of ``tests/test_distributed.py::test_dryrun_mini_cell``:
  ``run_cell("mamba2-370m", "long_500k", "single")`` at 256 fake ranks is
  ``ok`` and fits the H100, with the reference's record keys.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import REPO, SRC  # noqa: E402

from repro_torch.configs import (  # noqa: E402
    LM_SHAPES,
    get_config,
    list_archs,
    micro_batch_size,
    shape_by_name,
)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import MeshSpec  # noqa: E402

_REFERENCE = textwrap.dedent("""
    import os, json
    os.environ["REPRO_DRYRUN_DEVICES"] = "512"
    from repro.launch.dryrun import build_cell
    from repro.configs import LM_SHAPES, get_config, list_archs, micro_batch_size
    from repro.configs.shapes import cache_specs
    from repro.launch import sharding as shr
    import jax
    import repro.models
    out = {"cells": {}, "micro": {}}
    built = []
    real_build = repro.models.build_model
    def spy(cfg, *a, **k):
        built.append([cfg.act_shard_axis, list(cfg.act_batch_axes)])
        return real_build(cfg, *a, **k)
    repro.models.build_model = spy
    for arch in list_archs():
        cfg = get_config(arch)
        for s in LM_SHAPES:
            for n in (1, 7, 16, 32, 256, 512):
                out["micro"][f"{arch}|{s.name}|{n}"] = micro_batch_size(cfg, s, n)
            for multi in (False, True):
                built.clear()
                fn, args, meta = build_cell(arch, s.name, multi)
                mesh = meta.pop("_mesh", None)
                rec = {"meta": meta, "axes": built[-1] if built else None}
                if fn is not None:
                    rec["params"] = [
                        [jax.tree_util.keystr(p),
                         list(l.sharding.shard_shape(l.shape))]
                        for p, l in jax.tree_util.tree_flatten_with_path(
                            args[0])[0]]
                if fn is not None and meta["kind"] != "train":
                    specs = cache_specs(cfg, s.global_batch, s.seq_len)
                    shard = shr.cache_shardings(specs, cfg, mesh)
                    rec["cache"] = [
                        [jax.tree_util.keystr(p), list(sh.shard_shape(l.shape))]
                        for (p, l), sh in zip(
                            jax.tree_util.tree_flatten_with_path(specs)[0],
                            jax.tree.leaves(shard))]
                out["cells"][f"{arch}|{s.name}|{multi}"] = rec
    print("REF " + json.dumps(out))
""")

CELLS = [(a, s.name, m) for a in list_archs() for s in LM_SHAPES
         for m in (False, True)]
# The gloo cells: reduced widths in fp32, D 2 x M 2.
MESH = MeshSpec((2, 2), ("data", "model"))
USEC = dict(n_workers=4, t_stage=2, b_max=4, tile_samples=1, seq=32)
FSDP = dict(n_micro=2, rows=4, seq=32, weights=(1.0, 0.0, 1.0, 1.0))


def _cfg(arch):
    return dataclasses.replace(get_config(arch).reduced(),
                               param_dtype="float32",
                               grad_accum_dtype="float32")


def _zero1(cfg, d, shards):
    from repro_torch.launch import sharding
    from repro_torch.models.parallel import meta_params, shard_params
    from repro_torch.models.transformer import tree_map
    from repro_torch.optim import adamw

    shapes = meta_params(cfg)
    mesh = MeshSpec((2, 2), ("data", "model"))
    specs = sharding.opt_shardings(
        sharding.param_shardings(shapes, cfg, mesh), mesh, shapes)["m"]
    cut = shard_params(shapes, cfg, 2, shards.rank, 2, d, moments=True)
    return specs, adamw.init(tree_map(
        lambda t: SimpleNamespace(shape=t.shape, device="cpu"), cut))


def _rank_job(rank, world, store, out_dir):
    import torch.distributed as dist

    from repro_torch.configs.shapes import batch_schema, demo_batch
    from repro_torch.launch.mesh import (
        coordinates,
        data_group,
        make_worker_mesh,
        model_group,
    )
    from repro_torch.models import build_model
    from repro_torch.models.parallel import DataShards, ModelShards
    from repro_torch.runtime.trainstep import (
        make_fsdp_train_step,
        make_usec_train_step,
    )

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    mesh = make_worker_mesh(USEC["n_workers"], 2, device_type="cpu")
    d, m = coordinates(mesh)
    shards = ModelShards(model_group(mesh), 2, m)
    out = {}
    # usec + ZeRO-1
    cfg = _cfg("glm4-9b")
    bundle = build_model(cfg, device="cpu", shards=shards)
    params = bundle.init(torch.Generator().manual_seed(0))
    specs, opt = _zero1(cfg, d, shards)
    n, t_stage, b_max = USEC["n_workers"], USEC["t_stage"], USEC["b_max"]
    staged = {k: np.zeros((n, t_stage) + shp, dt) for k, (shp, dt) in
              batch_schema(cfg, "train", 1, USEC["seq"]).items()}
    step = make_usec_train_step(bundle, t_stage, b_max,
                                group=data_group(mesh), static_trips=2,
                                reduced_grad_shardings=specs)
    step(params, opt, None, staged, np.zeros((n, b_max), np.int64),
         np.ones((n, b_max), np.float32), np.ones((n, 1), np.int64), 1e-4)
    out["usec"] = {"data": step.stats["bytes"],
                   "model": shards.stats["bytes"]}
    # fsdp
    cfg = _cfg("qwen1.5-110b")
    shards = ModelShards(model_group(mesh), 2, m)
    data = DataShards(data_group(mesh), 2, d)
    bundle = build_model(cfg, device="cpu", shards=shards, data=data)
    params = bundle.init(torch.Generator().manual_seed(0))
    _, opt = _zero1(cfg, d, shards)
    step = make_fsdp_train_step(bundle, FSDP["n_micro"], donate=True)
    step(params, opt, demo_batch(cfg, "train", FSDP["rows"], FSDP["seq"]),
         np.asarray(FSDP["weights"], np.float32), 1e-4)
    out["fsdp"] = {"data": data.stats["bytes"] + step.stats["bytes"],
                   "model": shards.stats["bytes"]}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's metas (a subprocess), the 4 gloo ranks, and the
    dry-runs of their steps, overlapped."""
    tmp = str(tmp_path_factory.mktemp("dryrun"))
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get(
        "PYTHONPATH", ""))
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=env, cwd=REPO)
    torch.multiprocessing.start_processes(
        _rank_job, args=(4, os.path.join(tmp, "store"), tmp), nprocs=4,
        start_method="spawn")
    ranks = []
    for r in range(4):
        with open(os.path.join(tmp, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    usec = dryrun.trace_usec(_cfg("glm4-9b"), MESH, trips=(2,), **USEC)
    fsdp = dryrun.trace_fsdp(_cfg("qwen1.5-110b"), MESH, **FSDP)
    out, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-4000:]
    line = next(ln for ln in out.splitlines() if ln.startswith("REF "))
    return {"ref": json.loads(line[4:]), "ranks": ranks,
            "usec": usec, "fsdp": fsdp}


def _group_bytes(res, group):
    name = res["group_names"][group]
    return res["cost"].groups[name]["bytes"]


@pytest.mark.parametrize("kind", ["usec", "fsdp"])
def test_collective_bytes_equal_the_gloo_steps_stats(kind, runs):
    res = runs[kind]
    want = {g: _group_bytes(res, g) for g in ("data", "model")}
    assert want["data"] > 0 and want["model"] > 0
    for rank in runs["ranks"]:
        assert rank[kind] == want


@pytest.mark.parametrize("arch,shape,multi", CELLS)
def test_meta_and_rank0_slices_equal_the_reference(arch, shape, multi, runs):
    want = runs["ref"]["cells"][f"{arch}|{shape}|{multi}"]
    cell, meta = dryrun.build_cell(arch, shape, multi)
    assert meta == want["meta"]
    if cell is None:
        return
    # The sequence-parallel residual stream as the reference sets it: on
    # in every fsdp train cell, with the batch dim's data axes.
    assert [cell.cfg.act_shard_axis, list(cell.cfg.act_batch_axes)] == \
        want["axes"]
    if meta["kind"] == "train":
        assert bool(cell.cfg.act_shard_axis) == (meta["train_mode"] == "fsdp")
    got = [[k, list(s)] for k, s in cell.param_shapes()]
    assert got == want["params"]


@pytest.mark.parametrize("arch,shape,multi", [
    c for c in CELLS if shape_by_name(c[1]).kind != "train"])
def test_rank0_cache_cut_equals_the_reference(arch, shape, multi, runs):
    """A serving cell's rank-0 decode cache (a prefill's: of its prompt)
    against the reference's ``cache_shardings`` shard shapes."""
    want = runs["ref"]["cells"][f"{arch}|{shape}|{multi}"]
    cell, _ = dryrun.build_cell(arch, shape, multi)
    if cell is None:
        assert "cache" not in want
        return
    assert [[k, list(s)] for k, s in cell.cache_shapes()] == want["cache"]


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_serving_cell_traces_rank0_cut(shape):
    """A serving cell traces rank 0 over the production mesh's fake group:
    its arguments are exactly rank 0's bf16 parameter cut and cache cut
    (a decode's; a prefill's cache is its output), the model group moves
    bytes, and the cell fits the H100."""
    import math

    rec = dryrun.run_cell("glm4-9b", shape, "single", None)
    assert rec["status"] == "ok" and rec["hbm_fit"], rec
    assert rec["collective_groups"]["model"]["bytes"] > 0
    cell, _ = dryrun.build_cell("glm4-9b", shape, False)
    want = 2 * sum(math.prod(s) for _, s in cell.param_shapes())
    if shape == "decode_32k":
        want += 2 * sum(math.prod(s) for _, s in cell.cache_shapes())
    assert rec["memory"]["argument_bytes"] == want


def test_micro_batch_size_equals_the_reference(runs):
    for arch in list_archs():
        cfg = get_config(arch)
        for s in LM_SHAPES:
            for n in (1, 7, 16, 32, 256, 512):
                assert micro_batch_size(cfg, shape_by_name(s.name), n) == \
                    runs["ref"]["micro"][f"{arch}|{s.name}|{n}"]


def test_mini_cell_fits_the_h100(tmp_path):
    """Twin of test_dryrun_mini_cell: one full cell at 256 fake ranks,
    through the CLI, with the reference's record keys."""
    dryrun.main(["--arch", "mamba2-370m", "--shape", "long_500k",
                 "--mesh", "single", "--out", str(tmp_path)])
    with open(tmp_path / "mamba2-370m__long_500k__single.json") as fh:
        rec = json.load(fh)
    assert rec["status"] == "ok", rec
    assert rec["hbm_fit"] and 0 < rec["memory"]["peak_bytes"] < \
        dryrun.H100_HBM_BYTES
    assert rec["devices"] == 256
    for key in ("arch", "shape", "mesh", "devices", "meta", "status",
                "flops_per_device", "bytes_per_device", "model_flops_global",
                "model_flops_per_device", "dynamic_whiles",
                "collective_bytes_per_device", "collective_total", "memory",
                "hbm_fit", "trace_s"):
        assert key in rec, key
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "peak_bytes"}
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0


def test_cache_specs_hold_no_memory_and_match_init_cache():
    from repro_torch.configs import cache_specs, decode_inputs, input_specs
    from repro_torch.models.transformer import init_cache, tree_leaves

    cfg = get_config("recurrentgemma-2b").reduced()
    got = tree_leaves(cache_specs(cfg, 2, 64))
    want = tree_leaves(init_cache(cfg, 2, 64, device="cpu"))
    assert all(t.is_meta for t in got)
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want]
    fake = tree_leaves(cache_specs(cfg, 2, 64, device="cpu"))
    assert [tuple(t.shape) for t in fake] == [tuple(t.shape) for t in got]
    assert decode_inputs(cfg, 3) == {"token": ((3, 1), np.int32)}
    vlm = get_config("internvl2-2b")
    spec = input_specs(vlm, shape_by_name("train_4k"))
    p = min(vlm.prefix_len, 4096 // 4)
    assert spec == {"patches": ((256, p, vlm.frontend_dim), np.float32),
                    "tokens": ((256, 4096 - p), np.int32)}
