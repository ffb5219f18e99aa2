"""Learning-rate schedulers (counterpart of airgym_tpu/rl/schedulers.py;
reference lib/core/schedulers.py), as plain Python over (lr,
entropy_coef, epoch, frame, kl).

The trainers take their linear schedule from ``LinearScheduler``
(``rl/ppo.PPO._scheduled_lr``); the adaptive one stays in the update
(``rl/ppo.PPO.update`` and the update kernel), which applies it on the
device's kl."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class IdentityScheduler:
    """(schedulers.py:73-78)"""

    def update(self, lr, entropy_coef, epoch, frame, kl):
        return lr, entropy_coef


@dataclasses.dataclass(frozen=True)
class AdaptiveScheduler:
    """KL-driven x / ÷ 1.5 (schedulers.py:81-94)."""
    kl_threshold: float = 0.008
    min_lr: float = 1e-6
    max_lr: float = 1e-2

    def update(self, lr, entropy_coef, epoch, frame, kl):
        if kl > 2.0 * self.kl_threshold:
            lr = max(lr / 1.5, self.min_lr)
        if kl < 0.5 * self.kl_threshold:
            lr = min(lr * 1.5, self.max_lr)
        return lr, entropy_coef


@dataclasses.dataclass(frozen=True)
class LinearScheduler:
    """Linear decay by epochs or frames (schedulers.py:97-119)."""
    start_lr: float
    min_lr: float = 1e-6
    max_steps: int = 1_000_000
    use_epochs: bool = True
    apply_to_entropy: bool = False
    start_entropy_coef: float = 0.0

    def update(self, lr, entropy_coef, epoch, frame, kl):
        steps = epoch if self.use_epochs else frame
        mul = max(0.0, 1.0 - steps / self.max_steps)
        lr = max(self.min_lr, self.start_lr * mul)
        if self.apply_to_entropy:
            entropy_coef = self.start_entropy_coef * mul
        return lr, entropy_coef


def make(name: str, **kw):
    if name == "adaptive":
        return AdaptiveScheduler(**{k: v for k, v in kw.items()
                                    if k in ("kl_threshold", "min_lr",
                                             "max_lr")})
    if name == "linear":
        return LinearScheduler(**kw)
    return IdentityScheduler()
