"""Checkpoint/restart: atomic ``.npz`` shards plus a JSON manifest.

The port of :mod:`repro.runtime.checkpoint`, in the same on-disk format, so a
checkpoint written by either package restores in the other:

    <dir>/step_000123/
        manifest.json           (step, leaf index, shapes/dtypes, user meta)
        leaf_00000.npz ...      (one file per tree leaf, keyed by flat path)
    <dir>/LATEST                (atomic pointer file)

A tree is nested dicts, lists and tuples whose leaves are NumPy arrays, torch
tensors or scalars. Leaf keys are written as ``jax.tree_util.keystr`` writes
them (``"['operand']"``, ``"['nested'][0]"``), and dict keys are visited in
sorted order, as JAX flattens them. Tensors are fetched to the host on save;
on restore a leaf follows its prototype: a tensor prototype gives a tensor on
the prototype's device, anything else a host NumPy array (bit-exact, float64
included). bf16 and fp8 leaves are widened to float32 on disk (npz cannot
hold them) and cast back to the prototype's dtype on restore.

Integrity: every leaf file's bytes are CRC32-fingerprinted at save time and
re-checked on restore; a truncated or bit-flipped shard raises
:class:`CheckpointCorruptError` naming the file. Checkpoints without ``crc32``
keys restore without the check. The reference's ``shardings=`` argument
(re-placing leaves onto another JAX mesh) has no counterpart on one card.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "CheckpointCorruptError",
    "latest_checkpoint",
    "restore_checkpoint",
    "save_checkpoint",
]

# dtypes npz cannot hold: widened to float32 on disk, cast back on restore.
_WIDENED = ("bfloat16", "float8_e4m3fn", "float8_e5m2")


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file on disk fails its integrity check (truncated,
    bit-flipped, or unparsable). The message names the offending file."""


def _is_tensor(x) -> bool:
    return type(x).__module__.startswith("torch") and hasattr(x, "detach")


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr, leaf) pairs in JAX's flattening order. None is an empty
    subtree, as in JAX."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def _unflatten(like: Any, leaves: Dict[str, Any], prefix: str = "") -> Any:
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves, f"{prefix}[{k!r}]")
                for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves, f"{prefix}[{i}]")
                          for i, v in enumerate(like))
    return leaves[prefix]


def _host(leaf) -> Tuple[np.ndarray, str]:
    """The leaf as a host array to write, and the dtype name to record."""
    if _is_tensor(leaf):
        t = leaf.detach().cpu()
        name = str(t.dtype).replace("torch.", "")
        if name in _WIDENED:
            return t.float().numpy(), name
        return t.numpy(), name
    arr = np.asarray(leaf)
    name = str(arr.dtype)
    if arr.dtype.kind == "V" or name in _WIDENED:
        return arr.astype(np.float32), name
    return arr, name


def save_checkpoint(
    directory: str,
    step: int,
    tree: Any,
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Write a checkpoint atomically; returns the checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    flat = dict(_flatten(tree))
    tag = f"step_{step:09d}"
    tmp = tempfile.mkdtemp(prefix=f".{tag}.", dir=directory)
    index = []
    try:
        for i, (key, leaf) in enumerate(sorted(flat.items())):
            arr, dtype_str = _host(leaf)
            fname = f"leaf_{i:05d}.npz"
            np.savez(os.path.join(tmp, fname), value=arr)
            with open(os.path.join(tmp, fname), "rb") as lf:
                crc = zlib.crc32(lf.read())
            index.append(
                {"key": key, "file": fname, "shape": list(arr.shape),
                 "dtype": dtype_str, "crc32": crc}
            )
        manifest = {
            "step": int(step),
            "leaves": index,
            "extra": extra or {},
            "format_version": 1,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        final = os.path.join(directory, tag)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # Atomic LATEST pointer.
    ptr_tmp = os.path.join(directory, ".LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(tag)
    os.replace(ptr_tmp, os.path.join(directory, "LATEST"))
    return final


def latest_checkpoint(directory: str) -> Optional[str]:
    ptr = os.path.join(directory, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        tag = f.read().strip()
    path = os.path.join(directory, tag)
    return path if os.path.isdir(path) else None


def _restore_leaf(arr: np.ndarray, proto):
    if _is_tensor(proto):
        import torch

        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=proto.device, dtype=proto.dtype)
    if hasattr(proto, "dtype") and arr.dtype != proto.dtype:
        arr = arr.astype(proto.dtype)
    return arr


def restore_checkpoint(path: str, like: Any) -> Tuple[int, Any, Dict[str, Any]]:
    """Restore into the structure of ``like``. Returns (step, tree, extra).

    Raises :class:`CheckpointCorruptError` when the manifest is unparsable
    or a leaf file's bytes no longer match their save-time CRC32, KeyError
    when a leaf of ``like`` is missing, and ValueError on a shape mismatch.
    """
    mpath = os.path.join(path, "manifest.json")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointCorruptError(
            f"checkpoint manifest {mpath} is corrupt: {e}") from e
    by_key = {e["key"]: e for e in manifest["leaves"]}

    leaves: Dict[str, Any] = {}
    for key, proto in _flatten(like):
        if key not in by_key:
            raise KeyError(f"checkpoint missing leaf {key}")
        entry = by_key[key]
        fpath = os.path.join(path, entry["file"])
        if "crc32" in entry:
            with open(fpath, "rb") as lf:
                crc = zlib.crc32(lf.read())
            if crc != int(entry["crc32"]):
                raise CheckpointCorruptError(
                    f"checkpoint leaf {fpath} (key {key}) fails its "
                    f"integrity check: CRC32 {crc:#010x} != recorded "
                    f"{int(entry['crc32']):#010x} — the file was "
                    f"truncated or bit-flipped on disk")
        try:
            arr = np.load(fpath)["value"]
        except Exception as e:
            raise CheckpointCorruptError(
                f"checkpoint leaf {fpath} (key {key}) is unreadable: "
                f"{e}") from e
        want_shape = tuple(proto.shape) if hasattr(proto, "shape") else None
        if want_shape is not None and tuple(arr.shape) != want_shape:
            raise ValueError(
                f"leaf {key}: checkpoint shape {arr.shape} != expected "
                f"{want_shape}")
        leaves[key] = _restore_leaf(arr, proto)
    return int(manifest["step"]), _unflatten(like, leaves), \
        manifest.get("extra", {})
