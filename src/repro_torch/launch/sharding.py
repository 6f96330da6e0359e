"""Sharding rules: the per-dim placement of every parameter, optimizer,
cache and batch leaf over a ``("data", "model")`` mesh.

Twin of :mod:`repro.launch.sharding`, as plain data. A spec is a tuple of
per-dim entries: ``None`` (the dim is whole), an axis name, or a tuple of
names; ``()`` is the reference's ``P()`` (replicated). A mesh is anything
with ``.shape`` and ``.axis_names``: :class:`repro_torch.launch.mesh.MeshSpec`
(the shape a tuple, as here) or the reference's mesh (a mapping from axis
name to size). Trees are nested dicts and lists; a leaf is anything with a
``.shape``, and its key is written as ``jax.tree_util.keystr`` writes it
(``"['stack']['blocks'][0]['temporal']['wq']"``). This module builds no
tensors and imports neither torch nor ``torch.distributed``.

Two training modes (the reference's DESIGN.md §6):

  usec — params sharded over ``model`` only; the data axis is the USEC
         worker axis (its own uneven loops). The trainer cuts each leaf's
         ``"model"`` dim (:func:`repro_torch.models.parallel.shard_params`).
  fsdp — params sharded over (dp axes, model): each leaf is cut along its
         ``"model"`` dim and its data dim (:func:`data_dim`), and each layer
         gathers its data-cut leaves when it runs
         (:func:`repro_torch.models.parallel.gather_from_data`).
  ZeRO-1 (:func:`opt_shardings`): the AdamW moments cut over the dp axes
         too, in either mode; the train steps update those slices.
  dp   — every leaf replicated (``()``): model ranks compute the same step.

Every rule is divisibility-guarded: an axis that does not divide its dim,
or is not in the mesh, is dropped (that dim whole) rather than failing.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Optional, Tuple

Spec = Tuple[Any, ...]


def _sizes(mesh) -> Dict[str, int]:
    shape = mesh.shape
    if hasattr(shape, "items"):
        return dict(shape.items())
    return dict(zip(mesh.axis_names, shape))


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = _sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _guard(mesh, shape, spec_entries) -> Spec:
    """Drop axes that don't divide their dim or don't exist in the mesh. A
    one-name tuple is written as the name (as ``PartitionSpec`` holds it)."""
    out = []
    for dim, entry in zip(shape, spec_entries):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        if any(a not in mesh.axis_names for a in axes) or \
                dim % _axis_size(mesh, entry):
            out.append(None)
            continue
        out.append(axes[0] if len(axes) == 1 else axes)
    return tuple(out)


# ---------------------------------------------------------------------- #
# Parameter rules
# ---------------------------------------------------------------------- #
_RULES = [
    # (path regex, spec entries for the TRAILING dims, fsdp spec entries)
    (r"\['embed'\]$",          ("model", None),          ("model", "DP")),
    (r"\['unembed'\]$",        (None, "model"),          ("DP", "model")),
    (r"\['frontend_proj'\]$",  (None, None),             (None, "model")),
    (r"\['w(q|k|v)'\]$",       (None, "model"),          ("DP", "model")),
    (r"\['b(q|k|v)'\]$",       ("model",),               ("model",)),
    (r"\['wo'\]$",             ("model", None),          ("model", "DP")),
    (r"\['router'\]$",         (None, None),             (None, None)),
    # MoE experts: E over model (expert parallelism).
    (r"\['ffn'\]\['w_(gate|up)'\]$",   ("model", None, None), ("model", "DP", None)),
    (r"\['ffn'\]\['w_down'\]$",        ("model", None, None), ("model", None, "DP")),
    # shared expert / dense mlp
    (r"\['shared'\]\['w_(gate|up)'\]$", (None, "model"),      ("DP", "model")),
    (r"\['shared'\]\['w_down'\]$",      ("model", None),      ("model", "DP")),
    (r"\['w_(gate|up)'\]$",    (None, "model"),          ("DP", "model")),
    (r"\['w_down'\]$",         ("model", None),          ("model", "DP")),
    # ssm / rglru
    (r"\['w_in'\]$",           (None, "model"),          ("DP", "model")),
    (r"\['w_x'\]$",            (None, "model"),          ("DP", "model")),
    (r"\['w_(a|i)'\]$",        (None, "model"),          (None, "model")),
    (r"\['w_out'\]$",          ("model", None),          ("model", "DP")),
    (r"\['conv_w'\]$",         (None, "model"),          (None, "model")),
    (r"\['(lam|b_a|b_i)'\]$",  ("model",),               ("model",)),
    (r"\['norm_scale'\]$",     ("model",),               ("model",)),
]


def spec_for_param(key: str, shape: Tuple[int, ...], cfg, mesh) -> Spec:
    """The spec of one param leaf. ``shape`` may carry a leading stacked-layer
    axis (blocks), which is never sharded."""
    mode = cfg.train_mode
    if mode == "dp":
        # Pure data parallelism: every leaf replicated; the whole mesh is
        # the USEC worker axis.
        return ()
    dp = dp_axes(mesh)
    for pat, usec_spec, fsdp_spec in _RULES:
        if "ffn" in pat and not cfg.is_moe:
            continue  # expert rules (3-d stacked weights) are MoE-only
        if not re.search(pat, key):
            continue
        raw = fsdp_spec if mode == "fsdp" else usec_spec
        lead = len(shape) - len(raw)
        if lead < 0:
            continue
        entries = [None] * lead + [(dp if e == "DP" else e) for e in raw]
        return _guard(mesh, shape, entries)
    return ()  # norms, scalars, biases -> replicated


def keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys and list indices."""
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                   for k in path)


def map_with_path(fn: Callable, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists in JAX's order
    (dict keys sorted); ``None`` stays ``None``. A tuple is a leaf (a
    spec), not a node."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], path + (k,))
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def leaves(tree) -> list:
    """The leaves of a tree of dicts and lists, in :func:`map_with_path`'s
    order."""
    out: list = []
    map_with_path(lambda _, leaf: out.append(leaf), tree)
    return out


def param_shardings(param_shapes: Any, cfg, mesh) -> Any:
    """The spec of every leaf of a params-shaped tree."""
    return map_with_path(
        lambda path, leaf: spec_for_param(keystr(path), tuple(leaf.shape),
                                          cfg, mesh), param_shapes)


def opt_shardings(param_shardings_tree: Any, mesh, param_shapes: Any = None,
                  axes: Optional[Tuple[str, ...]] = None) -> Dict[str, Any]:
    """Moments follow the params + ZeRO-1: each moment is also sharded over
    the DP axes on its first still-unsharded divisible dim (given
    ``param_shapes``). The train steps take these as their
    ``reduced_grad_shardings`` (:mod:`repro_torch.runtime.trainstep`)."""
    dp = tuple(axes) if axes else dp_axes(mesh)
    dp_size = _axis_size(mesh, dp)

    def zero1(spec: Spec, shape: Tuple[int, ...]) -> Spec:
        padded = list(spec) + [None] * (len(shape) - len(spec))
        used = set()
        for e in padded:
            if e is not None:
                used.update(e if isinstance(e, tuple) else (e,))
        if any(a in used for a in dp):
            return spec  # fsdp mode: already dp-sharded
        for i, (dim, e) in enumerate(zip(shape, padded)):
            if e is None and dim % dp_size == 0 and dim > 0:
                padded[i] = dp if len(dp) > 1 else dp[0]
                return tuple(padded)
        return spec

    if param_shapes is None:
        mv = param_shardings_tree
    else:
        shapes = iter(leaves(param_shapes))
        mv = map_with_path(lambda _, spec: zero1(spec, tuple(next(shapes).shape)),
                           param_shardings_tree)
    return {"m": mv, "v": mv, "count": ()}


# ---------------------------------------------------------------------- #
# Batch / cache rules
# ---------------------------------------------------------------------- #
def batch_shardings(batch_specs: Dict[str, Any], mesh) -> Dict[str, Spec]:
    """Global batch arrays: leading batch dim over the DP axes."""
    dp = dp_axes(mesh)
    return {k: _guard(mesh, v.shape, [dp] + [None] * (len(v.shape) - 1))
            for k, v in batch_specs.items()}


def staged_shardings(staged_specs: Any, mesh) -> Any:
    """USEC staged buffers / plan arrays: leading worker axis over DP axes."""
    dp = dp_axes(mesh)
    return map_with_path(
        lambda _, v: _guard(mesh, v.shape, [dp] + [None] * (len(v.shape) - 1)),
        staged_specs)


def cache_shardings(cache_specs_tree: Any, cfg, mesh) -> Any:
    """Decode caches: batch over DP; heads (or head_dim) over model."""
    dp = dp_axes(mesh)
    msz = _sizes(mesh).get("model", 1)

    def one_leaf(path, leaf):
        key = keystr(path)
        shape = tuple(leaf.shape)
        entries: list = [None] * len(shape)
        # Leaves may carry a leading stacked-layer axis, so every structural
        # dim is indexed from the END.
        if re.search(r"\['(k|v)'\]$", key) and len(shape) >= 4:
            # (..., B, slots, hk, hd): the slots dim over model first.
            entries[-4] = dp
            if shape[-3] % msz == 0 and shape[-3] >= 4 * msz:
                entries[-3] = "model"
            elif shape[-2] % msz == 0:
                entries[-2] = "model"
            elif shape[-1] % msz == 0:
                entries[-1] = "model"
        elif re.search(r"\['state'\]$", key) and len(shape) >= 4:
            entries[-4] = dp  # (..., B, H, P, N)
            if shape[-3] % msz == 0:
                entries[-3] = "model"
        elif re.search(r"\['conv'\]$", key) and len(shape) >= 3:
            entries[-3] = dp  # (..., B, K-1, C)
            if shape[-1] % msz == 0:
                entries[-1] = "model"
        elif re.search(r"\['h'\]$", key) and len(shape) >= 2:
            entries[-2] = dp  # (..., B, D)
            if shape[-1] % msz == 0:
                entries[-1] = "model"
        else:
            entries[0] = dp
        return _guard(mesh, shape, entries)

    return map_with_path(one_leaf, cache_specs_tree)


def replicated(mesh) -> Spec:
    return ()


def guarded(mesh, shape: Tuple[int, ...], *entries) -> Spec:
    """A spec with divisibility-guarded entries (see :func:`_guard`)."""
    return _guard(mesh, shape, list(entries) + [None] * (len(shape) - len(entries)))


def model_dim(spec: Spec) -> Optional[int]:
    """The dim a spec puts on ``"model"`` alone (None if none does)."""
    for i, e in enumerate(spec):
        if e == "model":
            return i
    return None


def data_dim(spec: Spec) -> Optional[int]:
    """The dim a spec puts on the dp axes (``"pod"``, ``"data"`` or both;
    None if none does)."""
    for i, e in enumerate(spec):
        if e is not None and set(e if isinstance(e, tuple) else (e,)) <= \
                {"pod", "data"}:
            return i
    return None
