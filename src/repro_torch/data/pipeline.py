"""Deterministic synthetic data pipeline with USEC placement staging.

Twin of :mod:`repro.data.pipeline`, in NumPy over the port's own
``configs.shapes`` and ``core.placement``: the staged arrays are bitwise the
reference's. The train step moves them to the card.

The pipeline is the *storage layer* of the USEC system for training: the
global batch of each step is cut into ``G`` tiles (microbatch shards), and
every worker stages verbatim copies of the tiles its placement ``Z_n``
assigns — the uncoded storage of the paper, realized as host-RAM staging
buffers.

Tiles are generated deterministically from ``(seed, step, tile_id)`` so that
(a) any worker can materialize any tile it stores without communication,
(b) elastic re-planning (a tile moving to a different holder) never changes
the training data, and (c) restarts are bit-reproducible.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import batch_schema
from repro_torch.core.placement import Placement


@dataclass
class StagedBatch:
    """Per-worker staged tiles for one step.

    arrays: schema-keyed dict; each array has shape (N, T_stage, mb, ...).
    slot_of: (N, G) — staged slot of tile g on worker n (-1 if not stored).
    """

    arrays: Dict[str, np.ndarray]
    slot_of: np.ndarray
    tile_samples: int


class TokenPipeline:
    """Synthetic next-token data, tile-addressable."""

    def __init__(
        self,
        cfg: ArchConfig,
        placement: Placement,
        seq_len: int,
        tile_samples: int,
        seed: int = 0,
        kind: str = "train",
    ):
        self.cfg = cfg
        self.placement = placement
        self.seq = seq_len
        self.tile_samples = tile_samples
        self.seed = seed
        self.kind = kind
        self.schema = batch_schema(cfg, kind, tile_samples, seq_len)
        z = placement.storage_sets()
        self.t_stage = max(len(s) for s in z)
        self._z = z

    def tile(self, step: int, tile_id: int) -> Dict[str, np.ndarray]:
        """Materialize one tile (deterministic in (seed, step, tile_id))."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, tile_id])
        )
        out = {}
        for k, (shp, dt) in self.schema.items():
            if "int" in str(dt):
                # Zipf-ish marginal: the stream has learnable structure (a
                # uniform stream would pin the loss at log V exactly).
                v = self.cfg.vocab_size
                p = 1.0 / (np.arange(v) + 3.0)
                p /= p.sum()
                out[k] = rng.choice(v, size=shp, p=p).astype(np.int32)
            else:
                out[k] = rng.normal(size=shp).astype(np.float32)
        return out

    def staged_for_step(self, step: int) -> StagedBatch:
        """Stage every stored tile on every worker (host memory)."""
        n = self.placement.n_machines
        arrays = {
            k: np.zeros((n, self.t_stage) + shp, dtype=np.int32 if "int" in str(dt) else np.float32)
            for k, (shp, dt) in self.schema.items()
        }
        slot_of = np.full((n, self.placement.n_tiles), -1, np.int32)
        cache: Dict[int, Dict[str, np.ndarray]] = {}
        for w in range(n):
            for slot, g in enumerate(sorted(self._z[w])):
                if g not in cache:
                    cache[g] = self.tile(step, g)
                for k in arrays:
                    arrays[k][w, slot] = cache[g][k]
                slot_of[w, g] = slot
        return StagedBatch(arrays, slot_of, self.tile_samples)

    def global_batch(self, step: int) -> Dict[str, np.ndarray]:
        """The un-tiled global batch (for fsdp-mode steps and for checking
        that tiled execution reproduces it)."""
        tiles = [self.tile(step, g) for g in range(self.placement.n_tiles)]
        return {k: np.concatenate([t[k] for t in tiles], axis=0) for k in tiles[0]}
