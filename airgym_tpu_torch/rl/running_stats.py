"""Running mean / std normalizer (counterpart of
airgym_tpu/rl/running_stats.py; reference lib/core/running_mean_std.py).

Welford parallel merge, clamp at +-5, denormalize. The buffers are
float64, as the reference keeps them: at production step rates ``count``
passes 2^24 within seconds and float32 increments would round to zero.
(The JAX version carries Neumaier compensation terms instead, because a
TPU has no float64; ``rl/checkpoint.from_jax`` folds them back in.)

Immutable like its counterpart: ``update`` returns a new object.
Normalization runs in float32 from float32 copies of the stats.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class RunningMeanStd(NamedTuple):
    mean: torch.Tensor     # float64, stats shape
    var: torch.Tensor      # float64, stats shape
    count: torch.Tensor    # float64 scalar

    @staticmethod
    def create(shape, device=None) -> "RunningMeanStd":
        kw = dict(dtype=torch.float64, device=device)
        return RunningMeanStd(torch.zeros(shape, **kw), torch.ones(shape, **kw),
                              torch.tensor(1e-4, **kw))

    def update(self, batch: torch.Tensor) -> "RunningMeanStd":
        """Merge the statistics of ``batch`` (batch axes = leading axes)."""
        dims = tuple(range(batch.dim() - self.mean.dim()))
        if batch.dtype in (torch.float32, torch.float64):
            b = batch.to(torch.float64)
            b_mean = torch.mean(b, dim=dims)
            b_var = torch.var(b, dim=dims, unbiased=False)
        else:
            # bf16 camera frames: reduce in float32 as the JAX package
            # does (a float64 copy would be 4x the frame buffer)
            b_var, b_mean = torch.var_mean(batch.to(torch.float32),
                                           dim=dims, unbiased=False)
            b_var, b_mean = b_var.to(torch.float64), b_mean.to(torch.float64)
        b_count = batch.numel() / max(self.mean.numel(), 1)
        delta = b_mean - self.mean
        tot = self.count + b_count
        new_mean = self.mean + delta * b_count / tot
        m2 = (self.var * self.count + b_var * b_count
              + torch.square(delta) * self.count * b_count / tot)
        return RunningMeanStd(new_mean, m2 / tot, tot)

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = self.mean.to(x.dtype), self.var.to(x.dtype)
        return torch.clamp((x - mean) / torch.sqrt(var + 1e-5), -5.0, 5.0)

    def denormalize(self, y: torch.Tensor) -> torch.Tensor:
        mean, var = self.mean.to(y.dtype), self.var.to(y.dtype)
        return y * torch.sqrt(var + 1e-5) + mean
