"""The traced run's device trace, reduced to what the per-layer metrics read.

``torch.profiler`` (CUPTI) traces one slice at the start of the measured
window. The reduction reads the raw kineto events (no event tree is built):

- ``busy_s``: the union of the intervals in which a kernel, copy or memset
  ran on the device, inside the slice;
- ``kernels``: device seconds and count by short name;
- ``device_ops``: the ten entries that took most device time;
- ``idle_gaps``: device idle time inside the slice, by what the host thread
  was doing at each gap's middle (the innermost profiled host op or span),
  the ten largest.

A profiler can drop records late in a long process, so the generator checks
the count of a kernel's records against the launches it made.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

WINDOW_SPAN = "bench.traced_window"


def short(name: str) -> str:
    """A kernel's name without ``void`` and its argument list."""
    if name.startswith("void "):
        name = name[5:]
    cut = name.find("(")
    if cut > 0 and not name.startswith(("Memcpy", "Memset")):
        name = name[:cut]
    return name[:96]


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def warm_profiler() -> None:
    """Start and stop the profiler once, so its first-use cost (CUPTI's
    set-up) is paid in set-up and not inside the traced slice."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


class Slice:
    """One traced slice: :meth:`start`, the work, :meth:`stop`, then
    :meth:`reduce`."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.span = None
        self.window_s = 0.0
        self._t0 = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.span = torch.profiler.record_function(WINDOW_SPAN)
        self.span.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self._t0
        self.span.__exit__(None, None, None)
        self.prof.stop()

    def reduce(self) -> dict:
        evs = self.prof.profiler.kineto_results.events()
        win = None
        host: List[Tuple[int, int, str, int]] = []
        dev: List[Tuple[int, int, str]] = []
        cuda_type = torch.autograd.DeviceType.CUDA
        for e in evs:
            name = e.name()
            s, d = e.start_ns(), e.duration_ns()
            if e.device_type() == cuda_type:
                # The device side of a host annotation is a range, not
                # device work.
                if not (e.is_user_annotation() or name.startswith("bench.")):
                    dev.append((s, s + d, name))
            elif name == WINDOW_SPAN:
                win = (s, s + d, e.start_thread_id())
            else:
                host.append((s, s + d, name, e.start_thread_id()))
        if win is None:
            raise RuntimeError("the traced slice's span is missing")
        w0, w1, main = win
        dev = [(max(s, w0), min(t, w1), n) for s, t, n in dev
               if t > w0 and s < w1]
        kernels: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
        for s, t, n in dev:
            k = kernels[short(n)]
            k[0] += 1e-9 * (t - s)
            k[1] += 1
        busy, gaps = _union(sorted((s, t) for s, t, _ in dev), w0, w1)
        named = _name_gaps(gaps, [h for h in host if h[3] == main])
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
        return {
            "window_s": self.window_s,
            "busy_s": busy,
            "kernels": {k: v for k, v in kernels.items()},
            "n_kernels": sum(v[1] for k, v in kernels.items()
                             if not is_copy(k)),
            "device_ops": [[k, v[0]] for k, v in top],
            "idle_gaps": named,
        }


def _union(ivals, w0: int, w1: int):
    """Busy seconds of sorted (start, end) intervals, and the idle gaps
    (start, end) between them inside [w0, w1]."""
    busy = 0
    gaps = []
    cur_s = cur_t = None
    edge = w0
    for s, t in ivals:
        if cur_t is None or s > cur_t:
            if cur_t is not None:
                busy += cur_t - cur_s
                edge = cur_t
            if s > edge:
                gaps.append((edge, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_t is not None:
        busy += cur_t - cur_s
        edge = cur_t
    if w1 > edge:
        gaps.append((edge, w1))
    return 1e-9 * busy, gaps


def _name_gaps(gaps, host) -> List[List]:
    """Seconds of idle device by the innermost host op running at each
    gap's middle (``idle`` when none was), the ten largest."""
    host = sorted(host)
    starts = [h[0] for h in host]
    spans = [h for h in host if h[2].startswith("bench.")]
    total: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid)
        name: Optional[str] = None
        best = -1
        # The innermost op is the latest-started one still running; host
        # ops are short, so a bounded look back finds it.
        for j in range(i - 1, max(-1, i - 4097), -1):
            s, t, n, _ = host[j]
            if t >= mid and s > best:
                best, name = s, n
                break
        if name is None:
            live = [h for h in spans if h[0] <= mid <= h[1]]
            if live:
                name = max(live)[2]
        total[name or "idle"] += 1e-9 * (g1 - g0)
    return [[k, v] for k, v in
            sorted(total.items(), key=lambda kv: -kv[1])[:10]]
