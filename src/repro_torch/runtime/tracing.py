"""Host spans at the layer boundaries of the engine, the runner and the
server.

``with span("runner.fetch", tag):`` marks one piece of host work, and
``@traced("runner.adopt", "_step")`` a whole method, tagged with an
attribute of ``self`` read at the call. Tracing is off unless one of
two things is active, and off it costs two flag checks: :func:`span`
returns one shared object whose ``with`` does nothing, allocates nothing
and calls no torch op.

- **A profiler** (any ``torch.profiler`` session): every span also enters
  ``torch.profiler.record_function(name)``, so it lands in the kineto trace
  on the device trace's own clock, and an idle gap on the device can be
  named by the span the host was in.
- **A** :class:`Recorder`: every span is kept in memory as ``(name, tag,
  parent, t0_ns, t1_ns)`` on ``time.perf_counter_ns``; ``parent`` is the
  index of the enclosing span on the same thread. :meth:`Recorder.summary`
  gives each name's count, total and self seconds, and the counters.

An async span (:func:`record_async`) is an interval whose start and end the
caller took, such as a request's wait in the server's queue; it is kept
beside the spans and is no span's child time.

This module imports no torch: the runner's host classes import it, and
they load without torch (a profiler is only looked for once torch is
loaded). The profiler check reads ``torch.autograd.profiler.
_is_profiler_enabled``, a module flag that torch sets while a profiler
session runs (torch 2.x; a test holds it to that); were it gone, spans
would only stop reaching the profiler.
"""

from __future__ import annotations

import functools
import sys
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

__all__ = ["Recorder", "record_async", "recording", "span", "stamp",
           "traced"]

_active: Optional["Recorder"] = None   # the recorder spans go to, if any
_modules = sys.modules


class _Off:
    """What :func:`span` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _profiler():
    """``torch.autograd.profiler`` while a profiler is on, else None."""
    prof = _modules.get("torch.autograd.profiler")
    return (prof if prof is not None
            and getattr(prof, "_is_profiler_enabled", False) else None)


class _Span:
    __slots__ = ("name", "tag", "_rf", "_rec", "_row")

    def __init__(self, name: str, tag):
        self.name = name
        self.tag = tag
        self._rf = None
        self._rec = None
        self._row = None

    def __enter__(self):
        prof = _profiler()
        if prof is not None:
            self._rf = prof.record_function(self.name)
            self._rf.__enter__()
        rec = _active
        if rec is not None:
            stack = rec._stack()
            self._rec = rec
            self._row = [self.name, self.tag,
                         stack[-1] if stack else None,
                         time.perf_counter_ns(), None]
            rec._rows.append(self._row)
            stack.append(self._row)
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self._row[4] = time.perf_counter_ns()
            self._rec._stack().pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def span(name: str, tag=None):
    """A context manager that marks one piece of host work as ``name``;
    ``tag`` identifies its step, job, window or request."""
    if _active is None:
        # _profiler() inlined: this is the whole cost of tracing off.
        prof = _modules.get("torch.autograd.profiler")
        if prof is None or not getattr(prof, "_is_profiler_enabled", False):
            return _OFF
    return _Span(name, tag)


def traced(name: str, tag: Optional[str] = None):
    """A method decorator: each call runs inside ``span(name, t)``, ``t``
    being the attribute ``tag`` of ``self`` at the call (None without
    ``tag``)."""
    def wrap(fn):
        @functools.wraps(fn)
        def method(self, *args, **kwargs):
            with span(name, None if tag is None else getattr(self, tag)):
                return fn(self, *args, **kwargs)
        return method
    return wrap


def recording() -> bool:
    """True while a :class:`Recorder` is active."""
    return _active is not None


def stamp() -> Optional[int]:
    """The recorder's clock (ns) while one is active, else None: the start
    of an async span taken where its end is not known yet."""
    return time.perf_counter_ns() if _active is not None else None


def record_async(name: str, tag, t0_ns: Optional[int],
                 t1_ns: Optional[int] = None) -> None:
    """Record an async span from ``t0_ns`` (a :func:`stamp`) to ``t1_ns``
    (now when None), under the innermost open span of this thread. Nothing
    is recorded without an active recorder or a start."""
    rec = _active
    if rec is None or t0_ns is None:
        return
    stack = rec._stack()
    rec._async.append([name, tag, stack[-1] if stack else None, t0_ns,
                       time.perf_counter_ns() if t1_ns is None else t1_ns])


def _device_allocs() -> int:
    """The caching allocator's ``num_device_alloc`` on the current CUDA
    device (``cudaMalloc`` calls so far); 0 without CUDA."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return 0
    return int(torch.cuda.memory_stats().get("num_device_alloc", 0))


class Recorder:
    """Keeps every span and async span between :meth:`start` and
    :meth:`stop` in memory; one recorder is active at a time. Usable as a
    context manager."""

    def __init__(self):
        self._rows: List[list] = []
        self._async: List[list] = []
        self._local = threading.local()
        self._alloc0 = 0
        self.counters: Dict[str, int] = {}

    def _stack(self) -> List[list]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def start(self) -> "Recorder":
        global _active
        if _active is not None:
            raise RuntimeError("another Recorder is already active")
        self._alloc0 = _device_allocs()
        _active = self
        return self

    def stop(self) -> "Recorder":
        global _active
        if _active is self:
            _active = None
            self.counters["num_device_alloc"] = (
                _device_allocs() - self._alloc0)
        return self

    def __enter__(self) -> "Recorder":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def _rows_as_tuples(self, rows) -> List[Tuple]:
        index = {id(r): i for i, r in enumerate(self._rows)}
        return [(n, tag, None if p is None else index[id(p)], t0, t1)
                for n, tag, p, t0, t1 in rows]

    @property
    def spans(self) -> List[Tuple]:
        """Spans ``(name, tag, parent, t0_ns, t1_ns)`` in the order they
        opened; ``parent`` is the enclosing span's index in this list,
        ``t1_ns`` None for a span still open."""
        return self._rows_as_tuples(self._rows)

    @property
    def async_spans(self) -> List[Tuple]:
        """Async spans ``(name, tag, parent, t0_ns, t1_ns)``, ``parent``
        as in :attr:`spans`."""
        return self._rows_as_tuples(self._async)

    def summary(self) -> Dict:
        """``{"spans": {name: {"count", "total_s", "self_s"}}, "counters":
        {...}}``: self is a span's duration less the part its child spans
        cover (an async span's self is its duration)."""
        child: Dict[int, int] = defaultdict(int)
        for _, _, p, t0, t1 in self._rows:
            if p is not None and t1 is not None:
                child[id(p)] += t1 - t0
        out: Dict[str, Dict] = {}
        for rows, own in ((self._rows, True), (self._async, False)):
            for r in rows:
                if r[4] is None:
                    continue
                d = r[4] - r[3]
                s = out.setdefault(r[0], {"count": 0, "total_s": 0.0,
                                          "self_s": 0.0})
                s["count"] += 1
                s["total_s"] += 1e-9 * d
                s["self_s"] += 1e-9 * (d - child[id(r)] if own else d)
        return {"spans": out, "counters": dict(self.counters)}
