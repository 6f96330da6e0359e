"""--arch registry: every assigned architecture as a selectable config."""

from __future__ import annotations

import importlib
from typing import Dict, List

from .base import ArchConfig

_MODULES: Dict[str, str] = {
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "stablelm-1.6b": "stablelm_1_6b",
    "qwen1.5-110b": "qwen1_5_110b",
    "nemotron-4-15b": "nemotron_4_15b",
    "glm4-9b": "glm4_9b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "hubert-xlarge": "hubert_xlarge",
    "internvl2-2b": "internvl2_2b",
    "mamba2-370m": "mamba2_370m",
}


def list_archs() -> List[str]:
    return sorted(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {list_archs()}")
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.CONFIG
