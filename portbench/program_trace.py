"""The program's own spans on a profiled stretch's device timeline.

``airgym_tpu_torch/rl/profiling.py`` records spans inside the program
(``epoch`` and its ``rollout``, ``bookkeeping``, ``gae``, ``stats``,
``dataset``, ``update``; the plain update's ``minibatch`` steps with
their ``loss``, ``backward``, ``adam``; ``rollout_fused``), stamped with
``time.time_ns()``, the clock kineto stamps the profiler's host events
with and converts the device's to (on the H100's machine a runtime call
lands within 5 us of a ``time.time_ns()`` read around it). ``Program``
reads, from the profiler's events of a stretch (device events, and the
CUDA runtime's host-side calls, which ``trace.Reading`` drops):

- idle device time by span: the gaps between the device events (their
  union, marker kernels left out, as ``trace.Reading`` reads idle), each
  split by its overlap with the innermost open span; a span's figure is
  the sum over its subtree, gap time with no span open goes to
  ``outside``;
- launches by span: the runtime's launch calls whose host time falls in
  the span;
- syncs by span: the runtime calls that block the host.

Per root span (epoch, or ``rollout_fused`` call) unless a reader divides
otherwise. The program is traced only in a stretch of this module's own,
made after the benchmark's profiled stretch and without its marker
kernels: the drivers leave the tracer off. A training driver makes it
(``train``) and keeps it in ``ctx["program"]`` (a ``Program``); an
env-only cell's is made from the cell's files the first time a reader
asks (``reading(ctx, cell)``). A per-layer reader reads a span with
``reading(ctx).idle_ms("gae")``, ``.launches("epoch")`` or
``.syncs("epoch")``. The reading is None without a card, or where the
program has no tracer (``profiling.start``).
"""
from __future__ import annotations

import bisect
import itertools
import time
from typing import Dict, List, Optional

import torch

from portbench import harness
from portbench import trace as trace_mod

LAUNCH = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel",
          "cuLaunchKernel", "cudaLaunchKernelExC")
SYNC = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
        "cudaEventSynchronize", "cudaMemcpy")
OUTSIDE = "outside"
# the stretch's job and calls start from this seed: it reads host time,
# launches and syncs, which the drawn values do not steer
SEED = 20
# the stretch runs at least this long and one epoch or call: about 30
# Hovering epochs, one Planning epoch, 17 env-only calls on the H100
STRETCH_S = 0.5


class Program:
    """A stretch's program spans against its device and runtime events.

    ``records``: the tracer's records; ``start_ns``: the trace's start
    (``kineto_results.trace_start_ns()``); ``device``: (start us, end us)
    of each device event but the markers; ``runtime``: (host start us,
    name) of each host-side runtime event. Times in us are after the
    trace's start."""

    def __init__(self, records, start_ns: int, device, runtime):
        self.names = [r.name for r in records]
        self.parents = [r.parent for r in records]
        spans = [((r.start_ns - start_ns) * 1e-3,
                  (r.end_ns - start_ns) * 1e-3, i)
                 for i, r in enumerate(records) if r.end_ns is not None]
        self.roots = sum(1 for r in records
                         if r.parent < 0 and r.end_ns is not None)
        self.counts: Dict[str, int] = {}
        for name in self.names:
            self.counts[name] = self.counts.get(name, 0) + 1
        segs = _innermost(spans, self.parents)
        self._starts = [s[0] for s in segs]
        self._segs = segs
        self.idle_us = self._by_name(self._idle(sorted(device), segs))
        self.launch_n = self._by_name(self._points(
            [t for t, name in runtime if name in LAUNCH]))
        self.sync_n = self._by_name(self._points(
            [t for t, name in runtime if name in SYNC]))

    def _idle(self, device, segs) -> Dict[int, float]:
        """Each gap between device events split over the innermost spans
        it overlaps (-1: no span open)."""
        out: Dict[int, float] = {}
        end: Optional[float] = None
        j = 0
        for s, e in device:
            if end is not None and s > end:
                a, b, covered = end, s, 0.0
                while j < len(segs) and segs[j][1] <= a:
                    j += 1
                k = j
                while k < len(segs) and segs[k][0] < b:
                    o = min(b, segs[k][1]) - max(a, segs[k][0])
                    if o > 0:
                        out[segs[k][2]] = out.get(segs[k][2], 0.0) + o
                        covered += o
                    k += 1
                if b - a > covered:
                    out[-1] = out.get(-1, 0.0) + (b - a) - covered
            end = e if end is None else max(end, e)
        return out

    def _points(self, times) -> Dict[int, float]:
        """Each host time counted in the innermost span open at it."""
        out: Dict[int, float] = {}
        for t in times:
            k = bisect.bisect_right(self._starts, t) - 1
            i = (self._segs[k][2] if k >= 0 and t < self._segs[k][1]
                 else -1)
            out[i] = out.get(i, 0.0) + 1
        return out

    def _by_name(self, by_span: Dict[int, float]) -> Dict[str, float]:
        """Sums over each name's subtrees: a span's amount counts for its
        own name and each distinct name above it."""
        out: Dict[str, float] = {}
        for i, v in by_span.items():
            if i < 0:
                out[OUTSIDE] = out.get(OUTSIDE, 0.0) + v
                continue
            seen = set()
            while i >= 0:
                if self.names[i] not in seen:
                    seen.add(self.names[i])
                    out[self.names[i]] = out.get(self.names[i], 0.0) + v
                i = self.parents[i]
        return out

    def _per_root(self, by_name, name) -> Optional[float]:
        if not self.roots:
            return None
        return by_name.get(name, 0.0) / self.roots

    def idle_ms(self, name: str) -> Optional[float]:
        """Idle device ms in ``name``'s subtrees per root span."""
        v = self._per_root(self.idle_us, name)
        return None if v is None else 1e-3 * v

    def launches(self, name: str) -> Optional[float]:
        return self._per_root(self.launch_n, name)

    def syncs(self, name: str) -> Optional[float]:
        return self._per_root(self.sync_n, name)


def _innermost(spans, parents) -> List[tuple]:
    """(start, end, span index) pieces of the timeline on which each span
    is the innermost open one, in time order (spans nest, one thread)."""
    kids: Dict[int, list] = {}
    for s, e, i in spans:
        kids.setdefault(parents[i], []).append((s, e))
    segs = []
    for s, e, i in spans:
        t = s
        for cs, ce in kids.get(i, ()):
            if cs > t:
                segs.append((t, cs, i))
            t = max(t, ce)
        if e > t:
            segs.append((t, e, i))
    segs.sort()
    return segs


def from_window(win, records) -> Program:
    """The program reading of a ``trace.Window``'s stretch, from the
    profiler's raw events (``prof.events()`` builds the same events into
    a tree, which takes tens of seconds on a Planning epoch)."""
    res = win.prof.profiler.kineto_results
    start_ns = res.trace_start_ns()
    device, runtime = [], []
    for e in res.events():
        us = (e.start_ns() - start_ns) * 1e-3
        if e.device_type() != torch.autograd.DeviceType.CPU:
            if trace_mod.MARKER not in e.name():
                device.append((us, us + e.duration_ns() * 1e-3))
        elif e.name() in LAUNCH or e.name() in SYNC:
            runtime.append((us, e.name()))
    return Program(records, start_ns, device, runtime)


def _tracer():
    from airgym_tpu_torch.rl import profiling
    return profiling if hasattr(profiling, "start") else None


def _stretch(profiling, step, stop=None) -> Program:
    """``step()`` under ``trace.Window`` with the program traced, one step
    at least, until ``stop(elapsed s)`` (by default: ``STRETCH_S`` has
    passed)."""
    stop = stop or (lambda elapsed: elapsed >= STRETCH_S)
    with trace_mod.Window() as win:
        t0 = time.perf_counter()
        profiling.start()
        try:
            while True:
                step()
                if stop(time.perf_counter() - t0):
                    break
        finally:
            records = profiling.stop()
    return from_window(win, records)


def train(trainer, stop=None) -> Optional[Program]:
    """A new job of the traced run's trainer from ``SEED``: a stretch of
    epochs (``stop`` as in ``_stretch``; over ranks, the ranks' shared
    decision)."""
    profiling = _tracer()
    if profiling is None or not torch.cuda.is_available():
        return None
    ts = trainer.init(SEED)
    harness.sync(trainer.device)

    def step():
        nonlocal ts
        ts, _ = trainer.train_epoch(ts)
    return _stretch(profiling, step, stop)


def sim(cell: str) -> Optional[Program]:
    """The cell's env-only calls from a batch made from ``SEED``, each
    followed by the read of its summed reward, as the driver makes them;
    one call first builds and warms the kernel."""
    profiling = _tracer()
    if profiling is None or not torch.cuda.is_available():
        return None
    from airgym_tpu_torch import envs
    from airgym_tpu_torch.ops import fused_hovering as fh
    w = harness.cell(cell)
    tr, dev = w["traffic_file"], torch.device("cuda")
    task = envs.make_task(w["config_file"]["params"]["config"]["env_name"],
                          ctl_mode="rate", num_envs=tr["num_envs"],
                          obs_noise=False, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    packed = fh.pack_state(task.initial_state(gen).core)
    act = task.remap_actions(torch.tensor([tr["action"]],
                                          dtype=torch.float32,
                                          device=dev))[0]
    seeds = itertools.count(SEED)

    def step():
        _, r = fh.rollout_fused(packed, act, next(seeds), tr["steps"])
        float(torch.sum(r))
    step()
    return _stretch(profiling, step)


def reading(ctx, cell: Optional[str] = None) -> Optional[Program]:
    """The run's program reading: a training cell's as its driver made it
    (``train``), an env-only cell's (``cell``) made once from the cell's
    files and kept in ``ctx``."""
    if "program" not in ctx:
        ctx["program"] = None if cell is None else sim(cell)
    return ctx["program"]
