"""Config system: one module per assigned architecture, a registry for
--arch selection, and the model-input batch schemas. Pure data,
copied from :mod:`repro.configs` so the port needs nothing of the JAX
package; the dry-run's abstract specs (``input_specs``, ``cache_specs``,
``decode_inputs``) are not here."""

from .base import ArchConfig, LM_SHAPES, ShapeConfig, cell_applicable, shape_by_name
from .registry import get_config, list_archs
from .shapes import batch_schema, demo_batch

__all__ = [
    "ArchConfig",
    "LM_SHAPES",
    "ShapeConfig",
    "batch_schema",
    "cell_applicable",
    "demo_batch",
    "get_config",
    "list_archs",
    "shape_by_name",
]
