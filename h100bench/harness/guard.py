"""The run's own check that nothing of JAX or the JAX package is loaded."""

from __future__ import annotations

import sys
from typing import List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`FORBIDDEN`, compared whole: ``repro_torch`` is not ``repro``."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in list(mods) if m.split(".")[0] in FORBIDDEN)
