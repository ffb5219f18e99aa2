"""Actor-critic model, MLP branch (counterpart of
airgym_tpu/models/actor_critic.py).

Continuous A2C model with a global state-independent log-std
(``fixed_sigma: True``), a shared MLP trunk ([64,128,64] elu by default),
and mu / value heads initialized at 0.1x scale. Parameter names follow
the reference .pth keys: ``actor_mlp.layers.N.{weight,bias}``, ``mu.*``,
``value_head.*``, ``logstd``; a torch Linear weight is [out, in], which
is also the feature-major layout the fused kernels read.

The image encoders, the separate critic trunk, a state-dependent sigma
and activations other than elu are ROADMAP.md queue A item 12 and raise
until then.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn


def _lecun_normal_(w: torch.Tensor, scale: float,
                   generator: Optional[torch.Generator]) -> None:
    """flax's lecun_normal (truncated at 2 std) times ``scale``."""
    fan_in = w.shape[1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        w.mul_(scale)


class MLP(nn.Module):
    """elu trunk; ``layers.N`` are the reference's key names."""

    def __init__(self, in_dim: int, units: Sequence[int]):
        super().__init__()
        dims = [in_dim, *units]
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = nn.functional.elu(layer(x))
        return x


class ActorCritic(nn.Module):
    """Shared-trunk actor-critic with fixed log-std.

    ``forward(obs, obs_rms)`` normalizes the raw [B, D] observation with
    the running stats (when given) and returns (mu [B,A], sigma [B,A],
    value [B,1]).
    """

    def __init__(self, num_obs: int, num_actions: int,
                 units: Sequence[int] = (64, 128, 64),
                 activation: str = "elu", separate: bool = False,
                 fixed_sigma: bool = True, image_encoder=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if (separate or not fixed_sigma or image_encoder is not None
                or activation != "elu"):
            raise NotImplementedError(
                "only the shared-trunk fixed-sigma elu MLP actor-critic is "
                "ported: ROADMAP.md queue A item 12 (separate critic, "
                "state-dependent sigma, image encoders, other activations)")
        self.units = tuple(units)
        self.actor_mlp = MLP(num_obs, units)
        self.mu = nn.Linear(units[-1], num_actions)
        self.value_head = nn.Linear(units[-1], 1)
        self.logstd = nn.Parameter(torch.zeros(num_actions))
        for layer in self.actor_mlp.layers:
            _lecun_normal_(layer.weight, 1.0, generator)
            nn.init.zeros_(layer.bias)
        for head in (self.mu, self.value_head):
            _lecun_normal_(head.weight, 0.1, generator)
            nn.init.zeros_(head.bias)

    def forward(self, obs: torch.Tensor, obs_rms=None):
        x = obs_rms.normalize(obs) if obs_rms is not None else obs
        h = self.actor_mlp(x)
        mu = self.mu(h)
        sigma = torch.exp(self.logstd) * torch.ones_like(mu)
        return mu, sigma, self.value_head(h)


def neglogp(x, mu, sigma, logstd):
    """Diagonal-Gaussian negative log prob."""
    return (0.5 * torch.sum(torch.square((x - mu) / sigma), dim=-1)
            + 0.5 * math.log(2.0 * math.pi) * x.shape[-1]
            + torch.sum(logstd, dim=-1))


def entropy(logstd):
    """sum(logstd) + 0.5*A*log(2*pi*e) (rl_games' convention)."""
    a = logstd.shape[-1]
    return torch.sum(logstd, dim=-1) + 0.5 * a * (1.0 + math.log(2.0 * math.pi))
