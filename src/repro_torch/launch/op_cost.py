"""Cost of a step from the operators it dispatches: flops, bytes,
collectives and live memory, read as the step runs on meta tensors.

Twin of :mod:`repro.launch.hlo_cost`, which reads the same three roofline
inputs from compiled HLO text. The port has no compiled program: its step
is the eager sequence of aten operators (and the flash operator,
``torch.ops.repro_torch.flash_attention``) that autograd and the layers
dispatch, forward, recompute and backward, and :class:`OpCost` sees each
of them (a ``TorchDispatchMode``):

  flops        ``torch.utils.flop_counter``'s registry (what
               ``FlopCounterMode`` counts on the card), the flash
               operator's formula included (4·d per live (query, key) pair)
  bytes        the eager program's materialised-buffer traffic: each op
               its tensor operands plus its results; views 0 (an op whose
               result shares an operand's storage); an op that writes part
               of a tensor in place (``index_put_``, ``scatter_``,
               ``index_add_``, ...) 2 x the region written; ``copy_`` its
               source plus its destination (2 x the region for one dtype);
               allocation (``empty``) 0. Dtype casts count: in eager they
               do materialise (the reference's ``_op_traffic`` takes
               converts as free, fused on its target)
  collectives  per ``c10d`` op kind in the reference's convention
               (``hlo_cost.py``): all-reduce and all-to-all the tensor's
               bytes, all-gather the input's, reduce-scatter the input's
               (the output x the group); and per process group, by name,
               the whole tensor each collective handed the group (all-
               reduce the tensor, all-gather the output, reduce-scatter
               the input): the convention of the layers' own
               ``ModelShards`` / ``DataShards`` ``stats``
  memory       the bytes of every meta storage alive (each counted once
               whatever views it has, freed when its last reference goes),
               and the largest such total: the card's
               ``max_memory_allocated`` for the same program, the caching
               allocator's rounding aside

The reference's dynamic ``while`` (the usec step's per-worker loop) is its
trip-count hole: ``hlo_cost`` multiplies the body by an average trip count.
Here a step with uneven loops is traced at ``static_trips`` 1 and 2 and
:func:`extrapolate` takes ``cost(1) + (avg - 1)(cost(2) - cost(1))``.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# Ops that write only the region of their source into ``self``: the
# argument that holds that region.
_PARTIAL_WRITES = {"index_put_": 2, "_index_put_impl_": 2, "scatter_": 3,
                   "scatter_add_": 3, "index_add_": 3}
_ALLOCATIONS = {"empty", "empty_strided", "empty_like", "new_empty",
                "new_empty_strided"}
# The c10d ops the port's collectives dispatch -> (kind, index of the
# input tensor(s), index of the output).
_COLLECTIVES = {
    "allreduce_": ("all-reduce", 0, 0),
    "_allgather_base_": ("all-gather", 1, 0),
    "allgather_": ("all-gather", 1, 0),
    "_reduce_scatter_base_": ("reduce-scatter", 1, 0),
    "alltoall_base_": ("all-to-all", 1, 0),
}


def tensors(x) -> list:
    """The tensors in ``x``: a tensor, or lists, tuples and dicts of them."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for a in x for t in tensors(a)]
    if isinstance(x, dict):
        return [t for a in x.values() for t in tensors(a)]
    return []


def nbytes(x) -> int:
    """Bytes of the tensors in ``x`` (any nesting), each by its own extent."""
    return sum(t.numel() * t.element_size() for t in tensors(x))


@dataclass
class Cost:
    """One traced program's totals (per device, as ``hlo_cost.Cost``)."""

    flops: float = 0.0
    bytes: float = 0.0
    collectives: Dict[str, float] = field(default_factory=dict)
    groups: Dict[str, Dict[str, float]] = field(default_factory=dict)
    dynamic_loops: int = 0
    peak_bytes: int = 0


def extrapolate(one: Cost, two: Cost, avg_trips: float) -> Cost:
    """The cost of a step whose loops run ``avg_trips`` times on average,
    from its traces at 1 and 2 trips: ``one + (avg - 1)(two - one)`` for
    flops, bytes and collectives; the peak is the larger trace's;
    ``dynamic_loops`` 1."""
    k = avg_trips - 1.0

    def lin(a: float, b: float) -> float:
        return a + k * (b - a)

    def lin_map(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
        return {key: lin(a.get(key, 0.0), b.get(key, 0.0))
                for key in sorted(set(a) | set(b))}

    groups = {g: lin_map(one.groups.get(g, {}), two.groups.get(g, {}))
              for g in sorted(set(one.groups) | set(two.groups))}
    return Cost(flops=lin(one.flops, two.flops),
                bytes=lin(one.bytes, two.bytes),
                collectives=lin_map(one.collectives, two.collectives),
                groups=groups, dynamic_loops=1,
                peak_bytes=max(one.peak_bytes, two.peak_bytes))


class MemoryTracker:
    """Live bytes of the meta storages (the dry-run's card) that it has
    seen: :meth:`add` registers a tensor's storage (once), and the
    storage's collection takes its bytes off. ``peak`` is the largest live
    total since :meth:`reset_peak`."""

    def __init__(self):
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, int] = {}

    def add(self, t: torch.Tensor) -> None:
        if not t.is_meta:
            return
        st = t.untyped_storage()
        key = st._cdata
        size = st.nbytes()
        old = self._seen.get(key)
        if old is None:
            self._seen[key] = size
            weakref.finalize(st, self._free, key)
            self.live += size
        elif old != size:  # resized in place
            self._seen[key] = size
            self.live += size - old
        if self.live > self.peak:
            self.peak = self.live

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def reset_peak(self) -> None:
        self.peak = self.live


def _group_name(pg) -> str:
    import torch.distributed as dist

    if isinstance(pg, torch.ScriptObject):
        pg = dist.ProcessGroup.unbox(pg)
    return pg.group_name


class OpCost(TorchDispatchMode):
    """A dispatch mode that adds every operator it sees to ``cost`` and
    every meta result's storage to ``memory`` (a :class:`MemoryTracker`).
    Enter it with ``FlopCounterMode`` inside (:func:`traced`), which counts
    the flops."""

    def __init__(self, memory: Optional[MemoryTracker] = None):
        super().__init__()
        self.cost = Cost()
        self.memory = memory if memory is not None else MemoryTracker()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        ns, name = packet._qualified_op_name.split("::")
        if ns == "c10d":
            self._collective(name, args)
        else:
            self.cost.bytes += self._traffic(name, func, args, kwargs, out)
        for t in tensors(out):
            self.memory.add(t)
        return out

    def _collective(self, name: str, args) -> None:
        spec = _COLLECTIVES.get(name)
        if spec is None:
            return
        kind, i_in, i_out = spec
        moved = nbytes(args[i_in])
        whole = nbytes(args[i_in] if kind == "reduce-scatter"
                       else args[i_out])
        c = self.cost
        c.collectives[kind] = c.collectives.get(kind, 0.0) + moved
        pg = next((a for a in args if isinstance(a, torch.ScriptObject)
                   or type(a).__name__ == "ProcessGroup"), None)
        if pg is not None:
            g = c.groups.setdefault(_group_name(pg),
                                    {"collectives": 0.0, "bytes": 0.0})
            g["collectives"] += 1
            g["bytes"] += whole
        c.bytes += nbytes(args[i_in]) + nbytes(args[i_out])

    @staticmethod
    def _traffic(name: str, func, args, kwargs, out) -> float:
        if name in _ALLOCATIONS:
            return 0.0
        if name == "copy_":
            return float(nbytes(args[0]) + nbytes(args[1]))
        if name in _PARTIAL_WRITES:
            region = args[_PARTIAL_WRITES[name]]
            return 2.0 * nbytes(region)
        ins = tensors(args) + tensors(kwargs)
        outs = tensors(out)
        if not func._schema.is_mutable and _aliases(outs, ins):
            return 0.0  # a view
        return float(nbytes(ins) + nbytes(outs))


def _aliases(outs: Iterable[torch.Tensor], ins: Iterable[torch.Tensor]) -> bool:
    keys = {t.untyped_storage()._cdata for t in ins}
    outs = list(outs)
    return bool(outs) and all(t.untyped_storage()._cdata in keys
                              for t in outs)


_ACTIVE: list = []  # the traced blocks, innermost last


class traced:
    """``with traced(memory) as tc:`` runs the body under :class:`OpCost`
    with ``FlopCounterMode`` inside; after the block ``tc.cost`` holds the
    totals (flops from the counter, the peak from ``memory`` since entry,
    ``memory``'s peak reset at entry)."""

    def __init__(self, memory: Optional[MemoryTracker] = None):
        self.memory = memory if memory is not None else MemoryTracker()
        self.cost: Optional[Cost] = None
        self.replayed_flops = 0

    def __enter__(self):
        from torch.utils.flop_counter import FlopCounterMode

        self.memory.reset_peak()
        self._mode = OpCost(self.memory)
        self._flops = FlopCounterMode(display=False)
        self._mode.__enter__()
        self._flops.__enter__()
        _ACTIVE.append(self)
        return self

    def snapshot(self) -> Cost:
        """The totals so far."""
        c = self._mode.cost
        return Cost(flops=float(self._flops.get_total_flops()
                                + self.replayed_flops),
                    bytes=c.bytes, collectives=dict(c.collectives),
                    groups={k: dict(v) for k, v in c.groups.items()})

    def add(self, delta: Cost) -> None:
        """Add a replayed call's cost (see :class:`replay_backward`)."""
        c = self._mode.cost
        self.replayed_flops += delta.flops
        c.bytes += delta.bytes
        for k, v in delta.collectives.items():
            c.collectives[k] = c.collectives.get(k, 0.0) + v

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        self._flops.__exit__(*exc)
        self._mode.__exit__(*exc)
        cost = self._mode.cost
        cost.flops = float(self._flops.get_total_flops()
                           + self.replayed_flops)
        cost.peak_bytes = self.memory.peak
        self.cost = cost
        return False


def _delta(after: Cost, before: Cost) -> Cost:
    return Cost(flops=after.flops - before.flops,
                bytes=after.bytes - before.bytes,
                collectives={k: v - before.collectives.get(k, 0.0)
                             for k, v in after.collectives.items()})


class replay_backward:
    """``with replay_backward(Fn):`` (``Fn`` a ``torch.autograd.Function``
    whose backward issues no collective and keeps nothing past its return)
    traces ``Fn``'s backward once per distinct call, keyed by its forward's
    tensor shapes and dtypes and its other arguments, and replays that
    trace for every later identical call inside a :class:`traced` block:
    the same flops and bytes, the same transient memory above what was
    live at the call, and new outputs of the same shapes. On meta tensors
    a call's cost is a function of that key alone, so the totals are the
    full trace's; the attention backward's recompute
    (``models.attention.FlashAttentionFn``) is most of a training step's
    dispatches, identical in every layer and micro-step."""

    def __init__(self, fn):
        self.fn = fn
        self.seen: Dict[Any, Any] = {}

    def __enter__(self):
        fn, seen = self.fn, self.seen
        self._forward, self._backward = fn.forward, fn.backward
        real_forward, real_backward = fn.forward, fn.backward

        def forward(ctx, *args):
            ctx.replay_key = tuple(
                (tuple(a.shape), a.dtype, tuple(a.stride()))
                if isinstance(a, torch.Tensor) else a for a in args)
            return real_forward(ctx, *args)

        def backward(ctx, *grads):
            tc = _ACTIVE[-1] if _ACTIVE else None
            key = (ctx.replay_key, tuple((tuple(g.shape), g.dtype)
                                         for g in grads))
            if tc is None:
                return real_backward(ctx, *grads)
            mem = tc.memory
            if key in seen:
                delta, transient, outs = seen[key]
                tc.add(delta)
                mem.peak = max(mem.peak, mem.live + transient)
                return tuple(None if o is None else torch.empty(
                    o[0], dtype=o[1], device=o[2]) for o in outs)
            before, live0, peak0 = tc.snapshot(), mem.live, mem.peak
            mem.peak = live0
            out = real_backward(ctx, *grads)
            transient = mem.peak - live0
            mem.peak = max(peak0, mem.peak)
            seen[key] = (_delta(tc.snapshot(), before), transient, tuple(
                None if o is None else (tuple(o.shape), o.dtype, o.device)
                for o in out))
            return out

        fn.forward, fn.backward = staticmethod(forward), staticmethod(backward)
        return self

    def __exit__(self, *exc):
        self.fn.forward = staticmethod(self._forward)
        self.fn.backward = staticmethod(self._backward)
        return False
