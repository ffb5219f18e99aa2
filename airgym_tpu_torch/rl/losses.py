"""PPO loss pieces the trainer switches on by config (counterpart of
airgym_tpu/rl/losses.py; reference lib/core/common_losses.py)."""
from __future__ import annotations

import torch


def smooth_clamp(x: torch.Tensor, mi: float, mx: float) -> torch.Tensor:
    """Sigmoid-smoothed clamp (common_losses.py:22-23), centred at the
    interval's midpoint: 1/(1+exp((-(x-mi)/(mx-mi)+0.5)*4))*(mx-mi)+mi."""
    t = (-(x - mi) / (mx - mi) + 0.5) * 4.0
    return 1.0 / (1.0 + torch.exp(t)) * (mx - mi) + mi
