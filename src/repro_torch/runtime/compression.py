"""Gradient compression with error feedback, and the flat buffers the
step's collectives reduce.

Twin of :mod:`repro.runtime.compression`. Each worker's gradient (plus its
error feedback) is quantized to int8 against a per-leaf scale carried from
the previous step, the workers' int8 values are summed exactly and
dequantized; each worker keeps its quantization error for its next step
(EF-SGD). The next scale covers the largest local magnitude over the
workers (the reference's ``pmax``).

The sum's wire dtype. The reference sums as int16 (127 x 256 = 32512 <
2^15). Neither gloo nor NCCL sums int16, so the port sums in
:func:`wire_dtype`: float16 while 127 x N <= 2048, int32 above. float16
holds every integer of magnitude <= 2^11 exactly, and every partial sum of
N values in [-127, 127], in any order a ring or tree takes, has magnitude
<= 127 x N; so for N <= 16 every addition is exact, at half the bytes of
fp32. int32 holds 127 x N exactly up to N = 16,909,320, the most workers
the step accepts.

:class:`CompressedSum` streams one worker's gradient at a time, so only one
needs to exist. Over a process group each rank adds its own workers
(``ef[i]`` is its ``i``-th worker's), sums them locally in the wire dtype,
and the ranks meet at one all-reduce of those sums (bucketed,
:func:`flat_buckets`) and one ``MAX`` all-reduce of the local maxima.
Without a group the local sum is the whole sum.

With model shards (``shards``, the rank's model group) each rank holds its
slice of the sharded leaves: the int8 values of a slice are summed over the
rank's data group (the ranks holding the same slice), its ``ef`` is the
slice's, and the next scale covers the whole leaf: the ``MAX`` runs over
the data group and then over the model group, as the reference's
``jnp.max`` over a leaf GSPMD shards over ``"model"`` followed by its
``pmax`` over the workers.

The error feedback is per worker. The reference returns its new state from
``shard_map`` with ``out_specs=P()`` and ``check_vma=False``: the array is
typed as replicated, but every device keeps its own worker's ``ef`` and
uses it on the next step; fetched to the host (``np.asarray``, a
checkpoint) it reads as worker 0's. The port keeps the same values
explicitly: ``ef`` leaves carry a leading axis over the process's workers,
``ef[i]`` is its ``i``-th worker's, and on one process ``ef[0]`` is what
the reference's host copy holds.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.models.transformer import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)

__all__ = ["CompressedSum", "compress_decompress", "flat_buckets",
           "init_state", "wire_dtype"]

QMAX = 127
# float16's significand holds every integer up to 2^11 exactly.
FP16_EXACT = 2048
# One collective's buffer (bytes); a larger leaf gets a buffer of its own.
BUCKET_BYTES = 256 << 20


def wire_dtype(n_workers: int) -> torch.dtype:
    """The dtype that sums ``n_workers`` int8 values exactly on gloo and
    NCCL: float16 up to 16 workers, int32 above; raises past int32."""
    if n_workers < 1:
        raise ValueError(f"{n_workers} workers")
    if QMAX * n_workers <= FP16_EXACT:
        return torch.float16
    if QMAX * n_workers <= torch.iinfo(torch.int32).max:
        return torch.int32
    raise ValueError(f"{n_workers} workers overflow an int32 sum of int8 "
                     "values")


def flat_buckets(shapes: Sequence[Tuple[int, ...]], dtype: torch.dtype,
                 device, tail: int = 0
                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Zeroed flat buffers of at most :data:`BUCKET_BYTES` each, packed with
    the leaves in order, and a view of each leaf's shape into them; the last
    buffer has ``tail`` more elements after its leaves. Reducing the buffers
    reduces every view."""
    cap = max(1, BUCKET_BYTES // torch.empty((), dtype=dtype).element_size())
    groups: List[List[int]] = [[]]
    used = 0
    for i, shape in enumerate(shapes):
        n = math.prod(shape)
        if groups[-1] and used + n > cap:
            groups.append([])
            used = 0
        groups[-1].append(i)
        used += n
    bufs, views = [], [None] * len(shapes)
    for j, group in enumerate(groups):
        sizes = [math.prod(shapes[i]) for i in group]
        extra = tail if j == len(groups) - 1 else 0
        buf = torch.zeros(sum(sizes) + extra, dtype=dtype, device=device)
        off = 0
        for i, n in zip(group, sizes):
            views[i] = buf[off:off + n].view(shapes[i])
            off += n
        bufs.append(buf)
    return bufs, views


def init_state(params: Any, n_workers: int = 1) -> Dict[str, Any]:
    """``ef``: fp32 zeros (n_workers, *leaf shape) per leaf, one row per
    worker this process runs; ``scale``: an fp32 1e-2 per leaf, on the
    parameters' devices."""
    ef = tree_map(lambda p: torch.zeros((n_workers,) + tuple(p.shape),
                                        dtype=torch.float32, device=p.device),
                  params)
    scale = tree_map(lambda p: torch.tensor(1e-2, dtype=torch.float32,
                                            device=p.device), params)
    return {"ef": ef, "scale": scale}


class CompressedSum:
    """The quantize + exact sum + dequantize of one step, one worker's
    gradient at a time: ``add(i, grads)`` for each of this process's
    workers, then :meth:`result`.

    ``n_workers`` is the worker count over the whole group (default: this
    process's workers times the group's size); it picks the wire dtype.
    ``group``: the ranks to sum over, or None for one process; ``shards``:
    this rank's model group (the scales' ``MAX`` spans it too). After
    :meth:`result`, ``collectives`` and ``wire_bytes`` count the all-reduces
    it issued and the bytes they reduced (0 without a group)."""

    def __init__(self, state: Dict[str, Any], n_workers: Optional[int] = None,
                 group=None, shards=None):
        self.state, self.group = state, group
        self.shards = shards if shards is not None and shards.size > 1 \
            else None
        self._ef = tree_leaves(state["ef"])
        self._scale = tree_leaves(state["scale"])
        world = 1
        if group is not None:
            import torch.distributed as dist

            world = dist.get_world_size(group)
        rows = self._ef[0].shape[0]
        if n_workers is None:
            n_workers = rows * world
        if rows * world != n_workers:
            raise ValueError(f"the error feedback holds {rows} workers' rows; "
                             f"this process runs {n_workers // world}")
        device = self._ef[0].device
        self._bufs, self._q = flat_buckets(
            [tuple(e.shape[1:]) for e in self._ef], wire_dtype(n_workers),
            device)
        self._new_ef = [torch.empty_like(e) for e in self._ef]
        self._max = torch.zeros(len(self._ef), dtype=torch.float32,
                                device=device)
        self.collectives = self.wire_bytes = 0

    def add(self, i: int, grads: Any) -> None:
        """This process's ``i``-th worker's local gradient tree (any float
        dtype)."""
        for j, g in enumerate(tree_leaves(grads)):
            g = g.to(torch.float32) + self._ef[j][i]
            q = torch.clamp(torch.round(g / self._scale[j]), -QMAX, QMAX)
            self._new_ef[j][i] = g - q * self._scale[j]
            self._q[j] += q.to(self._q[j].dtype)
            self._max[j] = torch.maximum(self._max[j],
                                         torch.max(torch.abs(g)))

    def result(self) -> Tuple[Any, Dict[str, Any]]:
        """(the dequantized sum, the new state)."""
        import torch.distributed as dist

        if self.group is not None:
            for buf in self._bufs:
                dist.all_reduce(buf, group=self.group)
            dist.all_reduce(self._max, op=dist.ReduceOp.MAX, group=self.group)
            self.collectives = len(self._bufs) + 1
            self.wire_bytes = sum(b.numel() * b.element_size()
                                  for b in self._bufs + [self._max])
        if self.shards is not None:
            dist.all_reduce(self._max, op=dist.ReduceOp.MAX,
                            group=self.shards.group)
            self.collectives += 1
            self.wire_bytes += self._max.numel() * self._max.element_size()
        like = self.state["scale"]
        reduced = [q.to(torch.float32) * s
                   for q, s in zip(self._q, self._scale)]
        scales = [torch.clamp(m / float(QMAX), min=1e-8)
                  for m in self._max.unbind()]
        return tree_unflatten(like, reduced), {
            "ef": tree_unflatten(like, self._new_ef),
            "scale": tree_unflatten(like, scales)}


def compress_decompress(worker_grads: Sequence[Any],
                        state: Dict[str, Any]) -> Tuple[Any, Dict[str, Any]]:
    """Quantize + sum + dequantize the workers' gradient trees (worker
    ``w``'s is ``worker_grads[w]``) with error feedback on one process.
    Returns (reduced_grads, new_state)."""
    acc = CompressedSum(state)
    for w, g in enumerate(worker_grads):
        acc.add(w, g)
    return acc.result()
