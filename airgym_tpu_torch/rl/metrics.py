"""Run records (counterpart of airgym_tpu/rl/metrics.py).

``MetricsWriter`` writes the reference's scalar namespaces:
losses/{a_loss,c_loss,bounds_loss,entropy}, info/{last_lr,kl,epochs},
performance/step_inference_rl_update_fps, rewards/{frame,iter},
episode_lengths/frame, Episode/<reward term> (the per-term means),
diagnostics/{clip_frac,explained_variance} and info/{success_rate,
env_success_rate}. It always appends them to ``events.jsonl`` (one JSON
object per scalar: tag, value, step) and also to TensorBoard under
``summaries/`` when ``torch.utils.tensorboard`` imports; without the
``tensorboard`` package only the JSONL log is written.
``IntervalWriter`` reproduces the reference's adaptive write throttle.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class MetricsWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir=os.path.join(log_dir,
                                                              "summaries"))
            except ImportError:   # no tensorboard package: JSONL only
                self._tb = None
        self._jsonl = open(os.path.join(log_dir, "events.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step)}) + "\n")

    def add_scalars(self, scalars: Dict[str, float], step: int) -> None:
        for tag, v in scalars.items():
            self.add_scalar(tag, v, step)
        self.flush()

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()
        self._jsonl.flush()

    def close(self) -> None:
        self.flush()
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()


class IntervalWriter:
    """At most one write per interval: ``min_interval`` seconds for the
    first ``defer_start`` seconds, then ``interval_frac`` of the elapsed
    run time (reference interval_summary_writer.py)."""

    def __init__(self, writer: MetricsWriter, defer_start: float = 50.0,
                 interval_frac: float = 0.002, min_interval: float = 2.0):
        self.writer = writer
        self.start = time.time()
        self.defer_start = defer_start
        self.interval_frac = interval_frac
        self.min_interval = min_interval
        self.last_write = 0.0

    def _interval(self) -> float:
        elapsed = time.time() - self.start
        if elapsed < self.defer_start:
            return self.min_interval
        return max(self.min_interval, elapsed * self.interval_frac)

    def add_scalars(self, scalars: Dict[str, float], step: int) -> None:
        now = time.time()
        if now - self.last_write >= self._interval():
            self.writer.add_scalars(scalars, step)
            self.last_write = now


def episode_terms(info: Dict[str, object]) -> Dict[str, float]:
    """Reward terms (tensors or arrays) -> their Episode/<key> means."""
    out = {}
    for k, v in info.items():
        if hasattr(v, "detach"):
            v = v.detach().float().cpu().numpy()
        out[f"Episode/{k}"] = float(np.mean(np.asarray(v)))
    return out
