"""Exponential moving statistics (counterpart of
airgym_tpu/rl/moving_stats.py; reference lib/core/moving_mean_std.py
GeneralizedMovingStats): the three updates, EMA mean / std (impl
'mean_std', which ``normalize_rms_advantage`` uses), min / max and a
percentile band, each a pure function of the state and a batch."""
from __future__ import annotations

import math
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


def update_min_max(ms: MovingStats, x: torch.Tensor,
                   decay: float = 0.99) -> MovingStats:
    """EMA of the batch min / max -> center (min + max) / 2, scale
    (max - min) / 2."""
    dims = tuple(range(x.dim() - ms.center.dim()))
    b_min = torch.amin(x, dim=dims)
    b_max = torch.amax(x, dim=dims)
    return _band(ms, b_min, b_max, decay)


def percentiles(x: torch.Tensor, qs) -> list:
    """The ``q``-th percentiles along dim 0, one per entry of ``qs``, with
    linear interpolation (``jnp.percentile``'s default: lo * (1 - w) +
    hi * w between the two order statistics around q / 100 * (n - 1)).
    One sort serves them all; ``torch.quantile`` would refuse inputs of
    more than 2^24 elements, which a flat batch of Planning's 98,304 x R
    rows stays under but a larger one need not."""
    n = x.shape[0]
    srt = torch.sort(x, dim=0).values
    out = []
    for q in qs:
        pos = q / 100.0 * (n - 1)
        lo = min(max(math.floor(pos), 0), n - 1)
        w = pos - lo
        out.append(srt[lo] * (1.0 - w) + srt[min(lo + 1, n - 1)] * w)
    return out


def update_percentile(ms: MovingStats, x: torch.Tensor, decay: float = 0.99,
                      lo_q: float = 5.0, hi_q: float = 95.0) -> MovingStats:
    """EMA of the batch's [lo_q, hi_q] percentile band."""
    flat = x.reshape(-1, *ms.center.shape) if ms.center.dim() else \
        x.reshape(-1)
    return _band(ms, *percentiles(flat, (lo_q, hi_q)), decay)


def _band(ms: MovingStats, b_lo, b_hi, decay: float) -> MovingStats:
    d = torch.where(ms.initialized > 0, decay, 0.0).to(ms.center.dtype)
    lo = d * (ms.center - ms.scale) + (1 - d) * b_lo
    hi = d * (ms.center + ms.scale) + (1 - d) * b_hi
    return MovingStats(center=(lo + hi) / 2, scale=(hi - lo) / 2,
                       initialized=torch.ones_like(ms.initialized))


def normalize(ms: MovingStats, x: torch.Tensor, eps: float = 1e-5):
    return (x - ms.center) / (ms.scale + eps)


def denormalize(ms: MovingStats, y: torch.Tensor, eps: float = 1e-5):
    return y * (ms.scale + eps) + ms.center
