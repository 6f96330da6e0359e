"""A configuration file's kind, its checks, and the program's configuration
built from it.

Two kinds of file sit under ``configs/``:

- ``usec``: a deployment of the paper's elastic power iteration (the file
  has ``placement``);
- ``model``: a model of the port's registry at its published widths (the
  file has ``arch``).

:func:`check` raises on a file's first fault, naming the key. A model
file is held to the model-configs guide's sizing rules: no width is ever
cut; heads are cut only to one chip's share of the layers that
``deployment.chips_per_layer`` chips divide; the floors (a whole period
and at least four layers, at least an eighth of the vocabulary) hold.
The published numbers are the file's own: each integer of ``widths``
that is not cut, and each cut's ``source``, is named in ``source_part``,
the part of the source the file copies.

Not yet taken: a cut in experts (the port has no expert layer that is
told which experts it holds and routes over all of them, so a cut would
build a narrower router) and ``leading_dense`` layers (neither the
program nor :mod:`model_work` builds or counts one).
"""

from __future__ import annotations

import dataclasses
import math
import re

# What a model file may cut: counts of layers, heads and vocabulary rows.
# Everything else in ``widths`` is a width, or (``n_experts``) a count the
# port cannot yet hold a share of.
REDUCIBLE = ("n_layers", "n_heads", "n_kv_heads", "vocab_size")
# Counts that a chip holds a share of: held x chips_per_layer = published.
SHARED = ("n_heads", "n_kv_heads")
TRUNK = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
         "vocab_size")
MOE = ("n_experts", "top_k", "n_shared_experts", "moe_d_ff")
# The other keys that the benchmark's count of the work reads
# (harness/model_work.py): a file gives each where its arch's value is
# not ArchConfig's default, so that the count never falls back on a
# default the program does not run.
COUNTED = ("qkv_bias", "act", "tie_embeddings", "window", "layer_pattern",
           "ssm_state", "frontend")
MODEL_KEYS = ("name", "arch", "source", "source_part", "deployment",
              "widths", "reduced", "assumed", "dtype", "guarantees")
DTYPES = ("bfloat16", "float32")
MIN_LAYERS = 4
VOCAB_SHARE = 8


def kind(data: dict) -> str:
    """``"usec"`` for a file with ``placement``, ``"model"`` for one with
    ``arch``."""
    if "placement" in data and "arch" not in data:
        return "usec"
    if "arch" in data and "placement" not in data:
        return "model"
    raise ValueError(f"{data.get('name', '?')}: a configuration has one of "
                     "'placement' (usec) or 'arch' (model)")


def check(data: dict) -> None:
    """Raise ValueError on the file's first fault, naming its key."""
    if kind(data) == "usec":
        _check_usec(data)
    else:
        _check_model(data)


def _fail(key: str, why: str):
    raise ValueError(f"{key}: {why}")


def _check_usec(data: dict) -> None:
    # The tiles divide into whole executor blocks.
    if data["matrix_size"] % (data["n_tiles"] * data["block_rows"]):
        _fail("matrix_size", f"{data['matrix_size']} is not a whole number "
              f"of n_tiles ({data['n_tiles']}) x block_rows "
              f"({data['block_rows']}) blocks")


def _arch(name):
    from repro_torch.configs import get_config, list_archs

    if name not in list_archs():
        _fail("arch", f"{name!r} is not in the port's registry "
              f"{list_archs()}")
    return get_config(name)


def _check_model(data: dict) -> None:
    for key in MODEL_KEYS:
        if key not in data:
            _fail(key, "missing")
    arch = _arch(data["arch"])
    dep = data["deployment"]
    chips = dep.get("chips_per_layer") if isinstance(dep, dict) else None
    if not isinstance(chips, int) or chips < 1:
        _fail("deployment.chips_per_layer", "a whole number >= 1")
    if not isinstance(dep.get("division"), str) or not dep["division"]:
        _fail("deployment.division", "a sentence on how each layer is "
              "divided over the chips")
    if data["dtype"] not in DTYPES:
        _fail("dtype", f"{data['dtype']!r} is not one of {DTYPES}")
    if not data["guarantees"]:
        _fail("guarantees", "states at least one")
    for key in ("assumed", "reduced", "widths"):
        if not isinstance(data[key], dict):
            _fail(key, "an object")

    widths, reduced = data["widths"], data["reduced"]
    fields = {f.name: f.default for f in dataclasses.fields(arch)}
    for key in widths:
        if key not in fields:
            _fail(f"widths.{key}", "not a field of ArchConfig")
    needed = list(TRUNK)
    if arch.n_experts > 0:
        needed += MOE
    needed += [k for k in COUNTED if getattr(arch, k) != fields[k]]
    for key in needed:
        if key not in widths:
            _fail(f"widths.{key}", f"missing (the arch gives "
                  f"{getattr(arch, key)!r})")

    published = {}
    for key, cut in reduced.items():
        if key == "n_experts":
            _fail("reduced.n_experts", "not cut yet: the port has no expert "
                  "layer that routes over all the published experts and "
                  "computes only those it holds")
        if key not in REDUCIBLE:
            _fail(f"reduced.{key}", f"a width, never cut; only {REDUCIBLE} "
                  "may be")
        if not isinstance(cut, dict) or "source" not in cut \
                or "why" not in cut:
            _fail(f"reduced.{key}", "needs its published 'source' value "
                  "and a 'why'")
        if key not in widths:
            _fail(f"reduced.{key}", "the held value goes in widths")
        published[key] = cut["source"]
        if key in SHARED and widths[key] * chips != cut["source"]:
            _fail(f"reduced.{key}", f"held {widths[key]} x chips_per_layer "
                  f"{chips} is not the published {cut['source']}: a cut in "
                  "heads is one chip's share")
    # Every published number is the source's: named in source_part.
    for key, value in widths.items():
        path = f"reduced.{key}" if key in published else f"widths.{key}"
        value = published.get(key, value)
        if type(value) is int and not re.search(
                rf"(?<![\d.]){value}(?![\d.])", data["source_part"]):
            _fail(path, f"the published {value} is not named in "
                  "source_part (a cut is listed in reduced)")

    if data.get("leading_dense", 0):
        _fail("leading_dense", "no leading dense layer is built by the "
              "program or counted by model_work yet")
    period = len(widths.get("layer_pattern", arch.layer_pattern))
    if widths["n_layers"] < max(MIN_LAYERS, period):
        _fail("widths.n_layers", f"{widths['n_layers']} is under "
              f"max({MIN_LAYERS}, a period of {period})")
    vocab = published.get("vocab_size", widths["vocab_size"])
    if widths["vocab_size"] < math.ceil(vocab / VOCAB_SHARE):
        _fail("widths.vocab_size", f"{widths['vocab_size']} is under an "
              f"eighth of the published {vocab}")
    arch_config(data)


def arch_config(data: dict):
    """The port's ``ArchConfig`` for a model file: its arch's registry
    entry with the file's ``widths`` in place (lists as tuples). The one way
    a model generator builds its program's configuration."""
    arch = _arch(data["arch"])
    widths = {k: tuple(v) if isinstance(v, list) else v
              for k, v in data["widths"].items()}
    return dataclasses.replace(arch, **widths)
