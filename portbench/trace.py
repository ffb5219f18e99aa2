"""Reading a ``torch.profiler`` window of device activity.

Only device activity is recorded (kernels, copies, memsets): a vision
epoch's host op events number in the millions and take minutes to read
back. What the host was doing during an idle gap comes from marker
kernels (``torch.cuda._sleep(1)``, a ``spin_kernel`` launch) that the
benchmark enqueues at each boundary of its own spans: a gap between the
markers of a span was spent by the host in that span.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

MARKER = "spin_kernel"
TOP = 10


class Marks:
    """Enqueues a marker kernel at each span boundary and remembers the
    span each one opens, in order."""

    def __init__(self):
        self.names: List[str] = []

    def __call__(self, name: str) -> None:
        self.names.append(name)
        torch.cuda._sleep(1)


class Window:
    """A profiled stretch of the run: ``with Window() as w: ...``; then
    ``w.read()``. The wall time runs from a synchronised start to a
    synchronised end."""

    def __init__(self):
        self.marks = Marks()
        self.prof = None
        self.window_s = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        # a first marker, unnamed, until the profiler records the device
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(*exc)
        return False

    def read(self) -> "Reading":
        cpu = torch.autograd.DeviceType.CPU
        evs = sorted(((e.time_range.start, e.time_range.end, e.name)
                      for e in self.prof.events()
                      if e.device_type != cpu),
                     key=lambda x: x[0])
        return Reading(evs, self.marks.names, self.window_s)


class Reading:
    """Device events (start us, end us, name) of a window, its marker
    spans and its wall seconds."""

    def __init__(self, events, mark_names, window_s):
        self.window_s = window_s
        self.events = [e for e in events if MARKER not in e[2]]
        # markers pair with the marks from the last one back: the unnamed
        # first one, or one the profiler dropped as it started, falls out
        markers = [e for e in events if MARKER in e[2]]
        n = min(len(markers), len(mark_names))
        self.markers = markers[len(markers) - n:]
        self.mark_names = mark_names[len(mark_names) - n:]

    def busy_s(self) -> float:
        """Seconds in which some device event ran (their union)."""
        return union_s(self.events)

    def device_ops(self) -> List[list]:
        by: Dict[str, float] = {}
        for s, e, n in self.events:
            by[n] = by.get(n, 0.0) + (e - s) * 1e-6
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])
                ][:TOP]

    def _span_at(self, t_us: float) -> str:
        name = "before the first mark"
        for (s, _, _), mark in zip(self.markers, self.mark_names):
            if s > t_us:
                break
            name = mark
        return name

    def idle_gaps(self) -> List[list]:
        """The longest idle stretches between device events, each named by
        the benchmark span the host was in; gaps of one span summed."""
        by: Dict[str, float] = {}
        end: Optional[float] = None
        for s, e, _ in self.events:
            if end is not None and s > end:
                name = self._span_at(end)
                by[name] = by.get(name, 0.0) + (s - end) * 1e-6
            end = e if end is None else max(end, e)
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])
                ][:TOP]

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops(),
                "idle_gaps": self.idle_gaps()}


def union_s(events) -> float:
    """Seconds covered by the union of events (start us, end us, name),
    sorted by start."""
    total, end = 0.0, None
    for s, e, _ in events:
        if end is None or s >= end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total * 1e-6
