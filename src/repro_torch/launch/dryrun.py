"""Multi-pod dry-run: trace rank 0's step of every (arch x shape x mesh)
cell on a fake 256- or 512-rank process group, without a card.

Twin of :mod:`repro.launch.dryrun`. The reference lowers and compiles each
cell for 256 or 512 forced host devices and reads the compiled program's
memory and cost analyses. The port has no compiled program: it runs rank
0's eager step itself, on meta tensors (no byte is allocated, no kernel
built or launched), over a ``"fake"`` process group of the mesh's size
(:func:`repro_torch.launch.mesh.make_fake_mesh`; every collective returns at
once), and reads the cost from the operators the step dispatches
(:mod:`repro_torch.launch.op_cost`). Meta tensors stand in for the card's:
``FakeTensorMode``'s fake CUDA tensors cannot be differentiated on a
CPU-only build of torch (autograd asks the CUDA device guard for a stream),
and the flash attention route takes a meta tensor as a card tensor
(``kernels.ops.card_route``), so the traced step dispatches what the card
runs.

For each cell this writes one JSON record with the reference's keys:
``arch``, ``shape``, ``mesh``, ``devices``, ``meta`` (equal to the
reference's ``build_cell`` meta), ``status``, ``flops_per_device``,
``bytes_per_device``, ``model_flops_global`` / ``_per_device``,
``dynamic_whiles``, ``collective_bytes_per_device``, ``collective_total``,
``memory.{argument,output,temp,peak}_bytes`` and ``hbm_fit`` (the peak
below :data:`H100_HBM_BYTES`); ``trace_s`` stands where the reference has
``lower_s``. It adds ``collective_groups`` (each group's whole-tensor bytes,
the layers' ``stats`` convention), ``setup_peak_bytes`` (the largest live
total while the parameters and optimizer state are made) and ``layout``
(what rank 0 holds). ``docs/port_map.md`` lists the reference's keys that
have no counterpart (``xla_*``, ``cpu_bf16_inflation_bytes``,
``peak_bytes_tpu``, ``hbm_fit_tpu``, ``compile_s``).

How the cells map onto the port's steps:

  usec train  the production mesh (16 x 16 ``data`` x ``model``, or 2 x 16
              x 16 with ``pod``): one USEC worker a data index (the
              reference's ``dp_axes``, ``("pod", "data")`` flattened into
              one group on two pods), the parameters cut over the model
              group, ZeRO-1's moments over the data group
              (``make_usec_train_step(group=, reduced_grad_shardings=)``);
  dp train    the reference's pure-DP ``worker_axes`` (every chip a
              worker): a one-dim ``"data"`` mesh over all 256 (512) ranks,
              one worker a rank, the parameters whole and the moments cut
              over all ranks (the reference's ``opt_shardings(...,
              axes=all)``): the same usec step over the world group;
  fsdp train  the production mesh, the sharded fsdp step over the data and
              model groups (``make_fsdp_train_step``, donating its state);
  prefill /   the production mesh through the port's serving entry points,
  decode      ``prefill`` and ``decode_step``: rank 0's batch rows (the
              batch cut over the data axes as the reference's
              ``batch_shardings`` cuts it, whole when they do not divide
              it), its parameters cut by the rules (the fsdp archs over
              the data group too; the pure-DP archs with the usec rules, as
              the reference serves them) and its decode cache by
              ``cache_shardings``.

The usec step's per-worker loop has its own trip count (the reference's
dynamic ``while``): a usec cell is traced at ``static_trips`` 1 and 2 and
its cost is ``cost(1) + (avg_trips - 1)(cost(2) - cost(1))``
(:func:`repro_torch.launch.op_cost.extrapolate`), its peak the larger. An
fsdp cell of more than two microbatches is traced at 1 and 2 microbatches
of the same rows and extrapolated to ``n_micro`` the same way (its loop's
trip count is known). Identical calls of the attention backward's
recompute are traced once and replayed
(:class:`repro_torch.launch.op_cost.replay_backward`).

A train cell sets the sequence-parallel residual stream by the reference's
rule: ``act_shard_axis`` ``"model"`` by default in fsdp mode (each rank of
the model group keeps its 1/M of the residual's sequence), off in the usec
and dp modes unless the config names it (``"none"``: off), with
``act_batch_axes`` the fsdp cells' data axes.

Usage:
  python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] --out results/dryrun_torch
Each cell writes <out>/<arch>__<shape>__<mesh>.json.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import warnings
from types import SimpleNamespace
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import MeshSpec
from repro_torch.launch.op_cost import (
    Cost,
    MemoryTracker,
    extrapolate,
    replay_backward,
    tensors,
    traced,
)

# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB
# HBM3 (81079 MiB, read on the card): the card a cell must fit.
H100_HBM_BYTES = 85_017_493_504
H100_NAME = "NVIDIA H100 80GB HBM3"
DEVICE = "meta"  # the card's stand-in
LR = 1e-4


def _torch_dtype(dt) -> torch.dtype:
    return {np.dtype(np.int32): torch.int32,
            np.dtype(np.float32): torch.float32}[np.dtype(dt)]


class HostRows:
    """One schema array of every worker's staged tiles on the host, holding
    no memory: ``a[rows]`` gives a new meta tensor of those rows, the bytes
    the usec step moves to the card (its ``torch.as_tensor(v[rows])``)."""

    def __init__(self, shape: Tuple[int, ...], dtype):
        self.shape, self.dtype = tuple(shape), _torch_dtype(dtype)

    def __getitem__(self, rows: slice) -> torch.Tensor:
        n = len(range(*rows.indices(self.shape[0])))
        return torch.empty((n,) + self.shape[1:], dtype=self.dtype,
                           device=DEVICE)


class _Ranks:
    """Rank 0 of a fake process group over ``spec`` (None: one process):
    its data group (the dp axes, flattened), its model group (when the
    mesh has a ``"model"`` axis of more than one rank) and their names."""

    def __init__(self, spec: Optional[MeshSpec]):
        self.spec = spec
        self.group = self.shards = None
        self.n_data = self.n_model = 1
        self.names: Dict[str, str] = {}

    def __enter__(self):
        if self.spec is None:
            return self
        from repro_torch.launch.mesh import flat_group, make_fake_mesh
        from repro_torch.launch.sharding import dp_axes
        from repro_torch.models.parallel import ModelShards

        mesh = make_fake_mesh(self.spec)
        sizes = dict(zip(self.spec.axis_names, self.spec.shape))
        axes = dp_axes(self.spec)
        self.n_data = math.prod(sizes[a] for a in axes)
        self.group = flat_group(mesh, axes)
        self.names["data"] = self.group.group_name
        self.n_model = sizes.get("model", 1)
        if self.n_model > 1:
            mg = mesh.get_group("model")
            self.shards = ModelShards(mg, self.n_model, 0)
            self.names["model"] = mg.group_name
        return self

    def data(self):
        from repro_torch.models.parallel import DataShards

        if self.group is None or self.n_data == 1:
            return None
        return DataShards(self.group, self.n_data, 0)

    def __exit__(self, *exc):
        import torch.distributed as dist

        if self.spec is not None and dist.is_initialized():
            dist.destroy_process_group()
        return False


def _init(cfg, ranks: _Ranks, fsdp: bool):
    """(bundle, rank 0's parameters) on the meta device: its cut over the
    model group (and, for ``fsdp``, the data group) drawn streamed, as
    ``bundle.init`` does on the card."""
    from repro_torch.models import build_model

    bundle = build_model(cfg, device=DEVICE, shards=ranks.shards,
                         data=ranks.data() if fsdp else None)
    return bundle, bundle.init(torch.Generator().manual_seed(0))


def _replayed():
    """The attention backward's recompute traced once per distinct call
    (:class:`repro_torch.launch.op_cost.replay_backward`)."""
    from repro_torch.models.attention import FlashAttentionFn

    return replay_backward(FlashAttentionFn)


def _shapes(tree):
    from repro_torch.launch.sharding import keystr, map_with_path

    out = []
    map_with_path(lambda path, t: out.append((keystr(path), tuple(t.shape))),
                  tree)
    return out


def _moments(cfg, n_model: int, n_data: int):
    """Rank 0's AdamW state, the moments cut by ZeRO-1 over ``n_data``
    (nothing is made here: shapes only)."""
    from repro_torch.models.parallel import meta_params, shard_params
    from repro_torch.models.transformer import tree_map

    cut = shard_params(meta_params(cfg), cfg, n_model, 0, n_data, 0,
                       moments=True)
    return tree_map(lambda t: SimpleNamespace(shape=t.shape, device=DEVICE),
                    cut)


def _storage_bytes(tree) -> int:
    seen, total = set(), 0
    for t in tensors(tree):
        if t.device.type == DEVICE:
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                total += st.nbytes()
    return total


def _result(costs, mem_args, out_bytes, setup_peak, params, ranks,
            extra_args=0, avg_trips=None) -> Dict[str, Any]:
    cost = (costs[0] if avg_trips is None
            else extrapolate(costs[0], costs[1], avg_trips))
    return {"cost": cost, "costs": costs,
            "argument_bytes": mem_args + extra_args,
            "output_bytes": out_bytes, "setup_peak_bytes": setup_peak,
            "param_shapes": _shapes(params), "group_names": dict(ranks.names)}


def trace_usec(cfg, spec: Optional[MeshSpec], n_workers: int, t_stage: int,
               b_max: int, tile_samples: int, seq: int, zero1: bool = True,
               trips=(1, 2), avg_trips: Optional[float] = None
               ) -> Dict[str, Any]:
    """Rank 0's usec step (``make_usec_train_step``) of ``n_workers`` workers
    over ``spec``'s data group (one process when None), the parameters cut
    over its model group, with ZeRO-1 when ``zero1``: traced once per
    ``static_trips`` in ``trips``. Returns the costs, the bytes alive
    before the step (with this rank's staged rows), after it and at the
    setup's peak, rank 0's parameter shapes and the groups' names."""
    from repro_torch.configs.shapes import batch_schema
    from repro_torch.launch import sharding
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainstep import make_usec_train_step

    mem = MemoryTracker()
    with _Ranks(spec) as ranks:
        specs = None
        if zero1 and ranks.n_data > 1:
            from repro_torch.models.parallel import meta_params

            mspec = MeshSpec((ranks.n_data, ranks.n_model),
                             ("data", "model"))
            shapes = meta_params(cfg)
            specs = sharding.opt_shardings(
                sharding.param_shardings(shapes, cfg, mspec), mspec,
                shapes)["m"]
            moments = _moments(cfg, ranks.n_model, ranks.n_data)
        with traced(mem) as setup:
            bundle, params = _init(cfg, ranks, fsdp=False)
            opt = adamw.init(moments if specs is not None else params)
        schema = batch_schema(cfg, "train", tile_samples, seq)
        staged = {k: HostRows((n_workers, t_stage) + shp, dt)
                  for k, (shp, dt) in schema.items()}
        per_rank = n_workers // ranks.n_data
        rows_bytes = sum(per_rank * t_stage * math.prod(shp)
                         * np.dtype(dt).itemsize
                         for shp, dt in schema.values())
        mb_slot = np.zeros((n_workers, b_max), np.int64)
        mb_inc = np.ones((n_workers, b_max), np.float32)
        n_mb = np.ones((n_workers, 1), np.int64)
        args = mem.live
        costs = []
        with _replayed():
            for t in trips:
                step = make_usec_train_step(bundle, t_stage, b_max,
                                            group=ranks.group,
                                            static_trips=t,
                                            reduced_grad_shardings=specs)
                with traced(mem) as tc:
                    params, opt, _, metrics = step(params, opt, None, staged,
                                                   mb_slot, mb_inc, n_mb, LR)
                costs.append(tc.cost)
        out = _storage_bytes((params, opt, metrics))
        res = _result(costs, args, out, setup.cost.peak_bytes, params,
                      ranks, rows_bytes, avg_trips)
        del params, opt, metrics, bundle, step
    return res


def trace_fsdp(cfg, spec: Optional[MeshSpec], n_micro: int, rows: int,
               seq: int, weights=None,
               micro_trips: Optional[Tuple[int, int]] = None
               ) -> Dict[str, Any]:
    """Rank 0's sharded fsdp step (``make_fsdp_train_step``, donating its
    state) over ``spec``'s data and model groups: ``rows`` rows of ``seq``
    positions in ``n_micro`` microbatches (every rank passes the whole
    batch, as the step wants), with per-row ``weights`` (default ones).
    ``micro_trips`` = (1, 2): the step is traced at 1 and
    2 microbatches of the same size instead, and its cost extrapolated to
    ``n_micro`` (the micro-steps are identical; the reference's scan over
    them has a known trip count, which ``hlo_cost`` multiplies the same
    way)."""
    from repro_torch.configs.shapes import batch_schema
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainstep import make_fsdp_train_step

    mem = MemoryTracker()
    w = np.ones(rows, np.float32) if weights is None else np.asarray(
        weights, np.float32)
    with _Ranks(spec) as ranks:
        moments = _moments(cfg, ranks.n_model, ranks.n_data)
        with traced(mem) as setup:
            bundle, params = _init(cfg, ranks, fsdp=True)
            opt = adamw.init(moments)
            batch = {k: torch.zeros(shp, dtype=_torch_dtype(dt),
                                    device=DEVICE)
                     for k, (shp, dt) in batch_schema(
                         cfg, "train", rows, seq).items()}
        args = mem.live
        runs = [(n_micro, batch, w)]
        if micro_trips is not None:
            mb = rows // n_micro
            runs = [(k, {n: t[:k * mb] for n, t in batch.items()},
                     w[:k * mb]) for k in micro_trips]
        costs = []
        with _replayed():
            for k, b, wk in runs:
                step = make_fsdp_train_step(bundle, k, donate=True)
                with traced(mem) as tc:
                    params, opt, metrics = step(params, opt, b, wk, LR)
                costs.append(tc.cost)
        out = _storage_bytes((params, opt, metrics))
        res = _result(costs, args, out, setup.cost.peak_bytes, params, ranks,
                      avg_trips=None if micro_trips is None else n_micro)
        if micro_trips is not None:
            res["cost"].dynamic_loops = 0
        del params, opt, metrics, bundle, step, batch
    return res


def trace_serve(cfg, kind: str, batch: int, seq: int,
                spec: Optional[MeshSpec] = None) -> Dict[str, Any]:
    """Rank 0's ``prefill`` of ``batch`` prompts of ``seq`` positions, or
    its ``decode_step`` of ``batch`` tokens against a cache of ``seq``
    positions at its last slot, over ``spec``'s fake group (one process
    when None): every rank passes the whole batch (host arrays holding no
    memory) and moves its own rows to the card, its parameters cut over
    the model group (and over the data group for the fsdp archs), its
    cache cut by the reference's ``cache_shardings``."""
    from repro_torch.configs.shapes import batch_schema, cache_specs
    from repro_torch.models import build_model

    mem = MemoryTracker()
    with _Ranks(spec) as ranks:
        bundle = build_model(cfg, device=DEVICE, shards=ranks.shards,
                             data=ranks.data())
        with traced(mem) as setup:
            params = bundle.init(torch.Generator().manual_seed(0))
            if kind == "prefill":
                inputs = {k: np.broadcast_to(np.zeros((), dt), shp)
                          for k, (shp, dt) in batch_schema(
                              cfg, "prefill", batch, seq).items()}
            else:
                inputs = {"cache": cache_specs(cfg, batch, seq, DEVICE,
                                               spec),
                          "token": np.zeros((batch, 1), np.int32)}
        args = mem.live
        with torch.no_grad(), traced(mem) as tc, warnings.catch_warnings():
            # the host arrays are read-only broadcasts: nothing writes them
            warnings.filterwarnings("ignore", "The given NumPy array is not "
                                    "writable")
            if kind == "prefill":
                out = bundle.prefill(params, inputs)
            else:
                out = bundle.decode_step(params, inputs["cache"],
                                         inputs["token"], seq - 1,
                                         cache_len=seq)
        res = _result([tc.cost], args, _storage_bytes(out),
                      setup.cost.peak_bytes, params, ranks)
        res["cache_shapes"] = _shapes(out[0] if kind == "prefill"
                                      else inputs["cache"])
        del params, inputs, out, bundle
    return res


# ---------------------------------------------------------------------- #
# Cells
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class Cell:
    """One dry-run cell of the port: ``kind`` ``"usec"`` (the usec and dp
    train modes), ``"fsdp"``, ``"prefill"`` or ``"decode"``; ``spec`` the
    mesh rank 0 runs on (None: one process); ``args`` what :meth:`trace`
    hands its tracer."""

    kind: str
    cfg: Any
    spec: Optional[MeshSpec]
    args: Dict[str, Any]

    def trace(self) -> Dict[str, Any]:
        """Rank 0's step of the cell, traced (:func:`trace_usec`,
        :func:`trace_fsdp` or :func:`trace_serve`)."""
        if self.kind == "usec":
            return trace_usec(self.cfg, self.spec, **self.args)
        if self.kind == "fsdp":
            return trace_fsdp(self.cfg, self.spec, **self.args)
        return trace_serve(self.cfg, self.kind, spec=self.spec, **self.args)

    def param_shapes(self):
        """(key, shape) of every leaf of rank 0's parameters, made as the
        trace makes them (nothing else runs)."""
        with _Ranks(self.spec) as ranks:
            _, params = _init(self.cfg, ranks,
                              fsdp=self.kind in ("fsdp", "prefill",
                                                 "decode"))
            return _shapes(params)

    def cache_shapes(self):
        """(key, shape) of every leaf of rank 0's decode cache for a
        serving cell (a prefill's, of its prompt positions)."""
        from repro_torch.configs.shapes import cache_specs

        return _shapes(cache_specs(self.cfg, self.args["batch"],
                                   self.args["seq"], DEVICE, self.spec))


def train_axes(cfg, multi_pod: bool = False):
    """``cfg`` with the sequence-parallel residual stream set as the
    reference's dry-run sets it for a train cell: ``act_shard_axis``
    ``"model"`` by default in fsdp mode (the activation residency of the
    >= 100 B archs), off in usec and dp mode, a config's own choice kept
    (``"none"``: off); ``act_batch_axes`` the data axes in fsdp mode
    (``("pod", "data")`` on two pods), else none."""
    fsdp = cfg.train_mode == "fsdp"
    axis = cfg.act_shard_axis or ("model" if fsdp else "")
    batch = (("pod", "data") if multi_pod else ("data",)) if fsdp else ()
    return dataclasses.replace(cfg, act_shard_axis="" if axis == "none"
                               else axis, act_batch_axes=batch)


def build_cell(arch: str, shape_name: str, multi_pod: bool):
    """(cell, meta): the :class:`Cell` of rank 0's step and the reference's
    ``build_cell`` meta, key for key. A cell that does not apply gives
    (None, {"skip_reason": why}) with the reference's reason."""
    from repro_torch.configs import (
        cell_applicable,
        get_config,
        micro_batch_size,
        shape_by_name,
    )
    from repro_torch.core import compile_plan, cyclic_placement, solve_assignment
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.sharding import dp_axes

    cfg = get_config(arch)
    shape = shape_by_name(shape_name)
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        return None, {"skip_reason": why}
    if shape.kind == "train":
        cfg = train_axes(cfg, multi_pod)
    if shape.kind != "train" and cfg.train_mode == "dp":
        # Pure DP is a training choice; serving takes the usec layout.
        cfg = dataclasses.replace(cfg, train_mode="usec")
    meta = {"train_mode": cfg.train_mode, "avg_trips": 1.0,
            "n_active_params": cfg.n_active_params(),
            "n_params": cfg.n_params(), "kind": shape.kind,
            "tokens_global": shape.global_batch * (
                shape.seq_len if shape.kind != "decode" else 1)}
    spec = make_production_mesh(multi_pod=multi_pod)
    dp = dp_axes(spec)
    sizes = dict(zip(spec.axis_names, spec.shape))
    n_workers = math.prod(sizes[a] for a in dp)
    if shape.kind == "train":
        if cfg.train_mode in ("usec", "dp"):
            if cfg.train_mode == "dp":
                n_workers = math.prod(spec.shape)
                spec = MeshSpec((n_workers,), ("data",))
            tile_samples = micro_batch_size(cfg, shape, n_workers)
            g = max(shape.global_batch // max(tile_samples, 1), n_workers)
            g = min(g, shape.global_batch)
            tile_samples = max(shape.global_batch // g, 1)
            placement = cyclic_placement(n_workers, g, 2)
            sol = solve_assignment(placement, np.ones(n_workers),
                                   stragglers=1, lexicographic=False)
            plan = compile_plan(placement, sol, rows_per_tile=1,
                                stragglers=1)
            t_stage = max(len(z) for z in placement.storage_sets())
            b_max = int(plan.n_valid.max()) + 2
            meta["avg_trips"] = g * 2.0 / n_workers
            meta.update(G=g, tile_samples=tile_samples, t_stage=t_stage,
                        b_max=b_max)
            return Cell("usec", cfg, spec, dict(
                n_workers=n_workers, t_stage=t_stage, b_max=b_max,
                tile_samples=tile_samples, seq=shape.seq_len,
                avg_trips=meta["avg_trips"])), meta
        n_micro = max(shape.global_batch // max(
            micro_batch_size(cfg, shape, n_workers) * n_workers, 1), 1)
        meta.update(n_micro=n_micro)
        return Cell("fsdp", cfg, spec, dict(
            n_micro=n_micro, rows=shape.global_batch, seq=shape.seq_len,
            micro_trips=(1, 2) if n_micro > 2 else None)), meta
    return Cell(shape.kind, cfg, spec, dict(batch=shape.global_batch,
                                            seq=shape.seq_len)), meta


def _layout(meta, res, cfg) -> Dict[str, Any]:
    mode, kind = meta["train_mode"], meta["kind"]
    if kind != "train":
        return {"params": {"usec": "cut over the model group",
                           "fsdp": "cut over the data and model groups"}[
                               mode],
                "cache": "cut by cache_shardings (K/V slots, heads or "
                         "head dim over the model group, rows over data)",
                "rows": "rank 0's rows of the batch when the data axis "
                        "divides it, else every row",
                "groups": res["group_names"]}
    return {"params": {"usec": "cut over the model group",
                       "dp": "whole",
                       "fsdp": "cut over the data and model groups"}[mode],
            "moments": "cut over the data group (ZeRO-1)",
            "residual": ("cut on its sequence over the model group"
                         if cfg.act_shard_axis else "whole"),
            "groups": res["group_names"]}


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             out_dir: Optional[str]) -> Dict[str, Any]:
    multi = mesh_kind == "multi"
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_kind, "devices": 512 if multi else 256}
    t0 = time.time()
    cell, meta = build_cell(arch, shape_name, multi)
    if cell is None:
        rec["status"] = "skipped"
        rec["reason"] = meta["skip_reason"]
        _emit(rec, out_dir)
        return rec
    rec["meta"] = meta
    try:
        res = cell.trace()
        cost: Cost = res["cost"]
        coll = {k: int(v) for k, v in cost.collectives.items()}
        mult = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[meta["kind"]]
        model_flops_global = mult * meta["n_active_params"] * \
            meta["tokens_global"]
        names = {v: k for k, v in res["group_names"].items()}
        peak = max(cost.peak_bytes, res["argument_bytes"])
        rec.update(
            status="ok",
            trace_s=round(time.time() - t0, 2),
            flops_per_device=float(cost.flops),
            bytes_per_device=float(cost.bytes),
            model_flops_global=float(model_flops_global),
            model_flops_per_device=float(model_flops_global / rec["devices"]),
            dynamic_whiles=int(cost.dynamic_loops),
            collective_bytes_per_device=coll,
            collective_total=int(sum(coll.values())),
            collective_groups={names.get(g, g): v
                               for g, v in cost.groups.items()},
            memory={"argument_bytes": int(res["argument_bytes"]),
                    "output_bytes": int(res["output_bytes"]),
                    "temp_bytes": int(peak - res["argument_bytes"]),
                    "peak_bytes": int(peak)},
            setup_peak_bytes=int(res["setup_peak_bytes"]),
            hbm_fit=bool(peak < H100_HBM_BYTES),
            hbm=f"{H100_NAME}: {H100_HBM_BYTES} bytes",
            layout=_layout(meta, res, cell.cfg),
        )
    except Exception as e:  # record the failure; the dry-run must be fixable
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    _emit(rec, out_dir)
    return rec


def _emit(rec: Dict[str, Any], out_dir: Optional[str]) -> None:
    line = f"[{rec['arch']} | {rec['shape']} | {rec['mesh']}] {rec['status']}"
    if rec["status"] == "ok":
        m = rec["memory"]
        line += (f" trace={rec['trace_s']}s"
                 f" flops/dev={rec['flops_per_device']:.3e}"
                 f" peak={m['peak_bytes'] / 2 ** 30:.2f}GiB"
                 f" coll={rec['collective_total'] / 2 ** 20:.1f}MiB"
                 f" fit={rec['hbm_fit']}")
    elif rec["status"] == "skipped":
        line += f" ({rec['reason']})"
    else:
        line += f" {rec['error'][:200]}"
    print(line, flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        slug = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
        rec = dict(rec)
        rec.pop("traceback", None)
        with open(os.path.join(out_dir, slug), "w") as f:
            json.dump(rec, f, indent=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    from repro_torch.configs import LM_SHAPES, list_archs

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        archs = list_archs()
        shapes = [s.name for s in LM_SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        archs, shapes = [args.arch], [args.shape]
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                rec = run_cell(arch, shape, mk, args.out)
                failures += rec["status"] == "error"
    if failures:
        print(f"{failures} cell(s) FAILED", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
