"""PPO loss library (counterpart of airgym_tpu/rl/losses.py; reference
lib/core/common_losses.py and torch_ext.py).

The trainer (``rl/ppo.py``) inlines its own loss and calls only
``smooth_clamp`` from here; these elementwise functions are the rest of
the reference's loss surface: the surrogates, the critic losses, the
decoupled loss, the bound penalty and the diagnostics.
"""
from __future__ import annotations

import math

import torch


def smooth_clamp(x: torch.Tensor, mi: float, mx: float) -> torch.Tensor:
    """Sigmoid-smoothed clamp (common_losses.py:22-23), centred at the
    interval's midpoint: 1/(1+exp((-(x-mi)/(mx-mi)+0.5)*4))*(mx-mi)+mi."""
    t = (-(x - mi) / (mx - mi) + 0.5) * 4.0
    return 1.0 / (1.0 + torch.exp(t)) * (mx - mi) + mi


def actor_loss(old_neglogp, neglogp, advantage, is_ppo: bool, e_clip):
    """Clipped PPO surrogate (common_losses.py:39-48)."""
    if not is_ppo:
        return neglogp * advantage
    ratio = torch.exp(old_neglogp - neglogp)
    surr1 = advantage * ratio
    surr2 = advantage * torch.clamp(ratio, 1.0 - e_clip, 1.0 + e_clip)
    return torch.maximum(-surr1, -surr2)


def smoothed_actor_loss(old_neglogp, neglogp, advantage, is_ppo: bool,
                        e_clip):
    """PPO surrogate with the smooth clamp (common_losses.py:26-36,
    ``use_smooth_clamp`` in the config)."""
    if not is_ppo:
        return neglogp * advantage
    ratio = torch.exp(old_neglogp - neglogp)
    surr1 = advantage * ratio
    surr2 = advantage * smooth_clamp(ratio, 1.0 - e_clip, 1.0 + e_clip)
    return torch.maximum(-surr1, -surr2)


def default_critic_loss(value_preds, values, e_clip, returns,
                        clip_value: bool):
    """(common_losses.py:10-20)."""
    if clip_value:
        value_pred_clipped = value_preds + torch.clamp(
            values - value_preds, -e_clip, e_clip)
        value_losses = torch.square(values - returns)
        value_losses_clipped = torch.square(value_pred_clipped - returns)
        return torch.maximum(value_losses, value_losses_clipped)
    return torch.square(returns - values)


def critic_loss(value_preds, values, e_clip, returns, clip_value: bool):
    return default_critic_loss(value_preds, values, e_clip, returns,
                               clip_value)


def decoupled_actor_loss(behavior_neglogp, neglogp, proxy_neglogp,
                         advantage, e_clip):
    """Decoupled / behaviour-proxy PPO loss (common_losses.py:51-59;
    present but unused by the shipped configs)."""
    logratio = proxy_neglogp - neglogp
    pg1 = -advantage * torch.exp(behavior_neglogp - neglogp)
    clipped = torch.clamp(logratio, math.log(1.0 - e_clip),
                          math.log(1.0 + e_clip))
    pg2 = -advantage * torch.exp(clipped - proxy_neglogp + behavior_neglogp)
    return torch.maximum(pg1, pg2)


def bound_loss(mu, soft_bound: float = 1.1):
    """Soft action-bound penalty (a2c_continuous.py:382-390)."""
    high = torch.square(torch.clamp_min(mu - soft_bound, 0.0))
    low = torch.square(torch.clamp_max(mu + soft_bound, 0.0))
    return torch.sum(high + low, dim=-1)


def policy_kl(mu0, sigma0, mu1, sigma1, reduce: bool = True):
    """Diagonal-Gaussian KL (lib/core/torch_ext.py:27-36)."""
    c = (torch.log(sigma1 / sigma0 + 1e-7)
         + (torch.square(sigma0) + torch.square(mu1 - mu0))
         / (2.0 * torch.square(sigma1) + 1e-7) - 0.5)
    kl = torch.sum(c, dim=-1)
    return torch.mean(kl) if reduce else kl


def explained_variance(y_pred, y_true):
    """(lib/core/torch_ext.py:149-166), population variances."""
    var_y = torch.var(y_true, unbiased=False)
    return 1.0 - torch.var(y_true - y_pred, unbiased=False) / (var_y + 1e-8)


def policy_clip_fraction(new_neglogp, old_neglogp, e_clip):
    """(lib/core/torch_ext.py:168-178)."""
    ratio = torch.exp(old_neglogp - new_neglogp)
    return torch.mean((torch.abs(ratio - 1.0) > e_clip).to(torch.float32))
