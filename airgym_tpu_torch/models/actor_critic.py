"""Actor-critic model (counterpart of airgym_tpu/models/actor_critic.py).

Continuous A2C model with a global state-independent log-std
(``fixed_sigma: True``), a shared MLP trunk ([64,128,64] elu by default),
and mu / value heads initialized at 0.1x scale. Parameter names follow
the reference .pth keys: ``actor_mlp.layers.N.{weight,bias}``, ``mu.*``,
``value_head.*``, ``logstd``; a torch Linear weight is [out, in], which
is also the feature-major layout the fused kernels read.

Camera tasks add the CNN image encoder (``image_encoder='cnn'``): the
depth image [B, 1, W, H] is normalised per pixel, encoded to 30 features,
and the MLP reads [observation ++ features], normalised by the
'observation' running stats. Its keys are ``actor_cnn.features.{0,3,6}``
(convs), ``.features.{2,5,8}`` (batch norms) and ``actor_cnn.fc``.

The ResNet / VAE encoders, the separate critic trunk, a state-dependent
sigma and activations other than elu are ROADMAP.md queue A item 14 and
12d and raise until then.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn


def _lecun_normal_(w: torch.Tensor, scale: float,
                   generator: Optional[torch.Generator]) -> None:
    """flax's lecun_normal (truncated at 2 std) times ``scale``; the fan
    in of a conv weight [O, I, kh, kw] is I * kh * kw."""
    fan_in = w[0].numel()
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


class FrozenBatchNorm(nn.Module):
    """Eval-mode batch norm: y = x * s + t with s = weight / sqrt(var +
    1e-5), t = bias - mean * s, folded in float32 and applied in x's
    dtype. ``running_mean`` / ``running_var`` are frozen buffers (never
    updated, never trained); ``weight`` / ``bias`` learn. Not
    ``nn.BatchNorm2d`` in train mode, which would use batch statistics."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.int64))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.weight * torch.rsqrt(self.running_var + 1e-5)
        t = self.bias - self.running_mean * s
        return x * s.to(x.dtype)[:, None, None] + t.to(x.dtype)[:, None, None]


class _Conv(nn.Module):
    """Stride-2 conv with 'same'-style padding k // 2; in ``compute_dtype``
    the weight and bias are cast and the bias is added after the
    convolution, in that dtype, as the JAX package does."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.pad = k // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = nn.functional.conv2d(x, self.weight.to(x.dtype), None, stride=2,
                                 padding=self.pad)
        return y + self.bias.to(x.dtype)[:, None, None]


class CNNEncoder(nn.Module):
    """Depth-image feature extractor, layer for layer the reference
    CNNFeatureExtractor: conv(16,5,s2) -> ReLU -> BN, conv(32,3,s2) -> ReLU
    -> BN, conv(64,3,s2) -> ReLU -> BN, global mean pool in float32,
    fc(64 -> feature_dim). Input [B, C, W, H] in the JAX package's layout
    (the camera's width is the conv's first spatial axis).

    ``compute_dtype`` bfloat16 (default) runs the convs in bf16 with float32
    parameters; None runs them in float32. The convolutions go to cuDNN on
    the card (the JAX package leaves them to XLA outside any kernel)."""

    def __init__(self, in_channels: int = 1, feature_dim: int = 30,
                 compute_dtype=torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.features = nn.Sequential(
            _Conv(in_channels, 16, 5), nn.ReLU(), FrozenBatchNorm(16),
            _Conv(16, 32, 3), nn.ReLU(), FrozenBatchNorm(32),
            _Conv(32, 64, 3), nn.ReLU(), FrozenBatchNorm(64))
        self.fc = nn.Linear(64, feature_dim)
        for conv in (self.features[0], self.features[3], self.features[6]):
            _lecun_normal_(conv.weight, 1.0, generator)
        _lecun_normal_(self.fc.weight, 1.0, generator)
        nn.init.zeros_(self.fc.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        x = self.features(x)
        return self.fc(torch.mean(x.to(torch.float32), dim=(2, 3)))


class ActorCritic(nn.Module):
    """Shared-trunk actor-critic with fixed log-std.

    ``forward(obs, obs_rms)`` takes a raw [B, D] observation with its
    running stats, or a dict {'image': [B,1,W,H], 'observation': [B,D]}
    (or {'observation', 'features'}: encoder features computed already)
    with a dict of stats {'image', 'observation'}, and returns (mu [B,A],
    sigma [B,A], value [B,1]).
    """

    def __init__(self, num_obs: int, num_actions: int,
                 units: Sequence[int] = (64, 128, 64),
                 activation: str = "elu", separate: bool = False,
                 fixed_sigma: bool = True, image_encoder=None,
                 image_feature_dim: int = 30,
                 cnn_compute_dtype=torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if separate or not fixed_sigma or activation != "elu":
            raise NotImplementedError(
                "only the shared-trunk fixed-sigma elu actor-critic is "
                "ported: ROADMAP.md queue A item 12d (separate critic, "
                "state-dependent sigma, other activations)")
        if image_encoder not in (None, "cnn"):
            raise NotImplementedError(
                f"image encoder {image_encoder!r} is not ported yet: "
                f"ROADMAP.md queue A item 14")
        self.units = tuple(units)
        self.image_encoder = image_encoder
        in_dim = num_obs
        if image_encoder == "cnn":
            self.actor_cnn = CNNEncoder(feature_dim=image_feature_dim,
                                        compute_dtype=cnn_compute_dtype,
                                        generator=generator)
            in_dim = num_obs + image_feature_dim
        self.actor_mlp = MLP(in_dim, units)
        self.mu = nn.Linear(units[-1], num_actions)
        self.value_head = nn.Linear(units[-1], 1)
        self.logstd = nn.Parameter(torch.zeros(num_actions))
        for layer in self.actor_mlp.layers:
            _lecun_normal_(layer.weight, 1.0, generator)
            nn.init.zeros_(layer.bias)
        for head in (self.mu, self.value_head):
            _lecun_normal_(head.weight, 0.1, generator)
            nn.init.zeros_(head.bias)

    def encode_image(self, img: torch.Tensor, obs_rms=None) -> torch.Tensor:
        """Camera frames [B, 1, W, H] (any float dtype) -> features; the
        per-pixel normalisation runs in float32."""
        img = img.to(torch.float32)
        if obs_rms is not None:
            img = obs_rms["image"].normalize(img)
        return self.actor_cnn(img)

    def encode(self, obs, obs_rms=None):
        """-> (MLP input after normalization, pre-normalization vector,
        which the trainer feeds to the running stats)."""
        if isinstance(obs, dict):
            vec = obs["observation"]
            feat = obs.get("features")
            if feat is None:
                feat = self.encode_image(obs["image"], obs_rms)
            prenorm = torch.cat([vec, feat], dim=-1)
            x = (obs_rms["observation"].normalize(prenorm)
                 if obs_rms is not None else prenorm)
            return x, prenorm
        x = obs_rms.normalize(obs) if obs_rms is not None else obs
        return x, obs

    def forward(self, obs, obs_rms=None, return_prenorm: bool = False):
        x, prenorm = self.encode(obs, obs_rms)
        h = self.actor_mlp(x)
        mu = self.mu(h)
        sigma = torch.exp(self.logstd) * torch.ones_like(mu)
        if return_prenorm:
            return mu, sigma, self.value_head(h), prenorm
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
