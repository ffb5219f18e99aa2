"""Exponential moving mean / std of the advantages (counterpart of
airgym_tpu/rl/moving_stats.py, impl 'mean_std'; reference
lib/core/moving_mean_std.py), used by ``normalize_rms_advantage``."""
from __future__ import annotations

from typing import NamedTuple

import torch


class MovingStats(NamedTuple):
    center: torch.Tensor
    scale: torch.Tensor
    initialized: torch.Tensor     # 0-d, 1.0 once updated

    @staticmethod
    def create(shape=(), device=None) -> "MovingStats":
        kw = dict(dtype=torch.float32, device=device)
        return MovingStats(torch.zeros(shape, **kw), torch.ones(shape, **kw),
                           torch.zeros((), **kw))


def update_mean_std(ms: MovingStats, x: torch.Tensor,
                    decay: float = 0.99) -> MovingStats:
    """EMA of the batch mean and (population) std; the first update takes
    the batch's values."""
    dims = tuple(range(x.dim() - ms.center.dim()))
    b_mean = torch.mean(x, dim=dims)
    b_std = torch.std(x, dim=dims, unbiased=False)
    d = torch.where(ms.initialized > 0, decay, 0.0).to(x.dtype)
    return MovingStats(center=d * ms.center + (1 - d) * b_mean,
                       scale=d * ms.scale + (1 - d) * b_std,
                       initialized=torch.ones_like(ms.initialized))


def normalize(ms: MovingStats, x: torch.Tensor, eps: float = 1e-5):
    return (x - ms.center) / (ms.scale + eps)
