"""Data substrate: deterministic tile-addressable synthetic pipeline (NumPy).
Twin of :mod:`repro.data`."""

from .pipeline import StagedBatch, TokenPipeline

__all__ = ["StagedBatch", "TokenPipeline"]
