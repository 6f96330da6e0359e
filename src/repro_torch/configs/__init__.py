"""Config system: one module per assigned architecture, a registry for
--arch selection, and the model-input batch schemas. Pure data,
copied from :mod:`repro.configs` so the port needs nothing of the JAX
package, and the dry-run's abstract specs (:mod:`.shapes`)."""

from .base import ArchConfig, LM_SHAPES, ShapeConfig, cell_applicable, shape_by_name
from .registry import get_config, list_archs
from .shapes import (
    batch_schema,
    cache_specs,
    decode_inputs,
    demo_batch,
    input_specs,
    micro_batch_size,
)

__all__ = [
    "ArchConfig",
    "LM_SHAPES",
    "ShapeConfig",
    "batch_schema",
    "cache_specs",
    "cell_applicable",
    "decode_inputs",
    "demo_batch",
    "get_config",
    "input_specs",
    "list_archs",
    "micro_batch_size",
    "shape_by_name",
]
