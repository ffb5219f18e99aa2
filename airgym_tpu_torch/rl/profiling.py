"""Timing and trace instrumentation (counterpart of
airgym_tpu/rl/profiling.py): the reference's three wall-clock fps
figures, and ``torch.profiler`` in place of ``jax.profiler`` for device
traces.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional


class StepTimer:
    """Accumulates the reference's performance/step_fps (env steps),
    step_inference_fps (steps + policy) and step_inference_rl_update_fps
    (steps + policy + update). Times are host wall-clock: a caller timing
    CUDA work synchronizes the device inside the span."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.step_time = 0.0
        self.play_time = 0.0
        self.update_time = 0.0
        self.frames = 0

    @contextlib.contextmanager
    def _span(self, field: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            setattr(self, field,
                    getattr(self, field) + time.perf_counter() - t0)

    def env_step(self):
        return self._span("step_time")

    def play(self):
        return self._span("play_time")

    def update(self):
        return self._span("update_time")

    def add_frames(self, n: int) -> None:
        self.frames += n

    def fps(self) -> Dict[str, float]:
        eps = 1e-9
        return {
            "performance/step_fps": self.frames / max(self.step_time, eps),
            "performance/step_inference_fps":
                self.frames / max(self.play_time, eps),
            "performance/step_inference_rl_update_fps":
                self.frames / max(self.play_time + self.update_time, eps),
        }


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the host and, where a GPU is
    present, the device, written to ``log_dir`` for TensorBoard's profile
    plugin (a Chrome trace); a no-op when ``log_dir`` is None."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def annotate(name: str):
    """A named span on the trace's timeline."""
    import torch
    return torch.profiler.record_function(name)
