"""Gradient compression with error feedback.

Twin of :mod:`repro.runtime.compression`. Each worker's gradient (plus its
error feedback) is quantized to int8 against a per-leaf scale carried from
the previous step, the workers' values are summed as int16 (127 x 256 =
32512 < 2^15, so up to 256 workers sum exactly) and dequantized; each
worker keeps its quantization error for its next step (EF-SGD). The next
scale covers the largest local magnitude over the workers.

On one card the reference's ``psum`` over the worker axis is a sum over the
workers' quantized gradients, streamed worker by worker
(:class:`CompressedSum`), so only one worker's gradient needs to exist at a
time.

The error feedback is per worker. The reference returns its new state from
``shard_map`` with ``out_specs=P()`` and ``check_vma=False``: the array is
typed as replicated, but every device keeps its own worker's ``ef`` and
uses it on the next step; fetched to the host (``np.asarray``, a
checkpoint) it reads as worker 0's. The port keeps the same values
explicitly: ``ef`` leaves carry a leading worker axis, ``ef[w]`` is worker
``w``'s, and ``ef[0]`` is what the reference's host copy holds.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from repro_torch.models.transformer import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)

__all__ = ["CompressedSum", "compress_decompress", "init_state"]


def init_state(params: Any, n_workers: int = 1) -> Dict[str, Any]:
    """``ef``: fp32 zeros (n_workers, *leaf shape) per leaf; ``scale``: an
    fp32 1e-2 per leaf, on the parameters' devices."""
    ef = tree_map(lambda p: torch.zeros((n_workers,) + tuple(p.shape),
                                        dtype=torch.float32, device=p.device),
                  params)
    scale = tree_map(lambda p: torch.tensor(1e-2, dtype=torch.float32,
                                            device=p.device), params)
    return {"ef": ef, "scale": scale}


class CompressedSum:
    """The quantize + int16 sum + dequantize of one step, one worker's
    gradient at a time: ``add(w, grads)`` for every worker, then
    :meth:`result`."""

    def __init__(self, state: Dict[str, Any]):
        self.state = state
        self._ef = tree_leaves(state["ef"])
        self._scale = tree_leaves(state["scale"])
        self._q = [torch.zeros(e.shape[1:], dtype=torch.int16,
                               device=e.device) for e in self._ef]
        self._new_ef = [torch.empty_like(e) for e in self._ef]
        self._max = [None] * len(self._ef)

    def add(self, w: int, grads: Any) -> None:
        """Worker ``w``'s local gradient tree (any float dtype)."""
        for i, g in enumerate(tree_leaves(grads)):
            g = g.to(torch.float32) + self._ef[i][w]
            q = torch.clamp(torch.round(g / self._scale[i]), -127, 127)
            self._new_ef[i][w] = g - q * self._scale[i]
            self._q[i] += q.to(torch.int16)
            m = torch.max(torch.abs(g))
            self._max[i] = m if self._max[i] is None else torch.maximum(
                self._max[i], m)

    def result(self) -> Tuple[Any, Dict[str, Any]]:
        """(the dequantized sum, the new state)."""
        like = self.state["scale"]
        reduced = [q.to(torch.float32) * s
                   for q, s in zip(self._q, self._scale)]
        scales = [torch.clamp(m / 127.0, min=1e-8) for m in self._max]
        return tree_unflatten(like, reduced), {
            "ef": tree_unflatten(like, self._new_ef),
            "scale": tree_unflatten(like, scales)}


def compress_decompress(worker_grads: Sequence[Any],
                        state: Dict[str, Any]) -> Tuple[Any, Dict[str, Any]]:
    """Quantize + sum + dequantize the workers' gradient trees (worker
    ``w``'s is ``worker_grads[w]``) with error feedback. Returns
    (reduced_grads, new_state)."""
    acc = CompressedSum(state)
    for w, g in enumerate(worker_grads):
        acc.add(w, g)
    return acc.result()
