"""Actor-critic model, as the two configurations build it: a shared
[64, 128, 64] elu trunk, a global state-independent log-std (``fixed_sigma``)
and mu / value heads initialized at 0.1x scale. Parameter names follow the
reference .pth keys: ``actor_mlp.layers.N.{weight, bias}``, ``mu.*``,
``value_head.*``, ``logstd``; a torch Linear weight is [out, in], which is
also the feature-major layout the fused kernels read.

Planning adds the CNN image encoder (``actor_cnn``, 30 features): the depth
image [B, 1, W, H] is normalised per pixel and encoded, and the MLP reads
[observation ++ features], normalised by the 'observation' running stats.
Its keys are ``actor_cnn.features.{0,3,6}`` (convs), ``.features.{2,5,8}``
(batch norms) and ``actor_cnn.fc``.

Another encoder comes in a file of its own: the network block ``<name>``
is built by ``models/<name>.py``, whose ``build(block, generator)``
returns (module, feature count) and whose ``MODULE`` names the module in
the parameter keys. A frozen part has ``requires_grad`` off, and Adam
leaves it out (``rl/ppo.trainable``).
"""
from __future__ import annotations

import importlib
import math
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

UNITS = (64, 128, 64)
HERE = Path(__file__).resolve().parent
# the network block's keys that are not an image encoder
TRUNK_KEYS = {"name", "separate", "space", "mlp"}


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
    """Trunk of elu after every layer; ``layers.N`` are the reference's key
    names."""

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
    updated, never trained); ``weight`` / ``bias`` learn."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.weight * torch.rsqrt(self.running_var + 1e-5)
        t = self.bias - self.running_mean * s
        return x * s.to(x.dtype)[:, None, None] + t.to(x.dtype)[:, None, None]


class _Conv(nn.Module):
    """Stride-2 conv with 'same'-style padding k // 2; the weight and bias
    are cast to the input's dtype and the bias is added after the
    convolution, in that dtype."""

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
    fc(64 -> feature_dim). Input [B, C, W, H] (the camera's width is the
    conv's first spatial axis). The convs run in bf16 with float32
    parameters, as the configuration states."""

    def __init__(self, feature_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = nn.Sequential(
            _Conv(1, 16, 5), nn.ReLU(), FrozenBatchNorm(16),
            _Conv(16, 32, 3), nn.ReLU(), FrozenBatchNorm(32),
            _Conv(32, 64, 3), nn.ReLU(), FrozenBatchNorm(64))
        self.fc = nn.Linear(64, feature_dim)
        for conv in (self.features[0], self.features[3], self.features[6]):
            _lecun_normal_(conv.weight, 1.0, generator)
        _lecun_normal_(self.fc.weight, 1.0, generator)
        nn.init.zeros_(self.fc.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x.to(torch.bfloat16))
        return self.fc(torch.mean(x.to(torch.float32), dim=(2, 3)))


class ActorCritic(nn.Module):
    """``forward(obs, obs_rms)`` takes a raw [B, D] observation with its
    running stats, or a dict {'image': [B,1,W,H], 'observation': [B,D]}
    (or {'observation', 'features'}: encoder features computed already)
    with a dict of stats {'image', 'observation'}, and returns (mu [B,A],
    sigma [B,A], value [B,1]). ``image_feature_dim`` > 0 adds the CNN, or
    ``encoder`` = (module name, module) when another encoder was built
    (``build``)."""

    def __init__(self, num_obs: int, num_actions: int,
                 image_feature_dim: int = 0,
                 generator: Optional[torch.Generator] = None,
                 encoder: Optional[Tuple[str, nn.Module]] = None):
        super().__init__()
        self.image_features = image_feature_dim
        self.encoder_module = None
        if encoder is not None:
            self.encoder_module = encoder[0]
            setattr(self, encoder[0], encoder[1])
        elif image_feature_dim:
            self.encoder_module = "actor_cnn"
            self.actor_cnn = CNNEncoder(image_feature_dim, generator)
        self.actor_mlp = MLP(num_obs + image_feature_dim, UNITS)
        self.mu = nn.Linear(UNITS[-1], num_actions)
        self.value_head = nn.Linear(UNITS[-1], 1)
        self.logstd = nn.Parameter(torch.zeros(num_actions))
        for layer in self.actor_mlp.layers:
            _lecun_normal_(layer.weight, 1.0, generator)
            nn.init.zeros_(layer.bias)
        for head in (self.mu, self.value_head):
            _lecun_normal_(head.weight, 0.1, generator)
            nn.init.zeros_(head.bias)

    def encode_image(self, img: torch.Tensor, obs_rms) -> torch.Tensor:
        """Camera frames [B, 1, W, H] (any float dtype) -> features; the
        per-pixel normalisation runs in float32."""
        return getattr(self, self.encoder_module)(obs_rms["image"].normalize(
            img.to(torch.float32)))

    def encode(self, obs, obs_rms):
        """-> (MLP input after normalization, pre-normalization vector,
        which the trainer feeds to the running stats)."""
        if isinstance(obs, dict):
            feat = obs.get("features")
            if feat is None:
                feat = self.encode_image(obs["image"], obs_rms)
            prenorm = torch.cat([obs["observation"], feat], dim=-1)
            return obs_rms["observation"].normalize(prenorm), prenorm
        return obs_rms.normalize(obs), obs

    def forward(self, obs, obs_rms, return_prenorm: bool = False):
        x, prenorm = self.encode(obs, obs_rms)
        h = self.actor_mlp(x)
        mu = self.mu(h)
        sigma = torch.exp(self.logstd) * torch.ones_like(mu)
        value = self.value_head(h)
        if return_prenorm:
            return mu, sigma, value, prenorm
        return mu, sigma, value


def build(network: dict, num_obs: int, num_actions: int, image: bool,
          generator: Optional[torch.Generator] = None) -> ActorCritic:
    """The YAML's ``network`` block -> ActorCritic. Only what the
    configurations state is built: a shared [64, 128, 64] elu trunk with a
    fixed sigma, and for image observations one encoder block: ``cnn``, or
    one whose ``models/<name>.py`` exists; anything else is refused."""
    mlp = network.get("mlp", {})
    got = (tuple(mlp.get("units", UNITS)), mlp.get("activation", "elu"),
           bool(network.get("separate", False)),
           bool(network.get("space", {}).get("continuous", {})
                .get("fixed_sigma", True)))
    if got != (UNITS, "elu", False, True):
        raise ValueError(f"the reference builds the shared [64, 128, 64] elu "
                         f"trunk with a fixed sigma only, got {got}")
    blocks = sorted(set(network) - TRUNK_KEYS)
    known = [b for b in blocks if b == "cnn" or _has_file(b)]
    if known != blocks or len(blocks) != int(image):
        raise ValueError(f"the reference builds one encoder block (cnn, or "
                         f"one of reference/plain/models/) for image "
                         f"observations only, got {sorted(network)}")
    if not image:
        return ActorCritic(num_obs, num_actions, 0, generator)
    name = blocks[0]
    if name == "cnn":
        return ActorCritic(num_obs, num_actions,
                           int(network["cnn"].get("output_dim", 30)),
                           generator)
    mod = importlib.import_module(f"{__package__}.{name}")
    module, feat = mod.build(network[name], generator)
    return ActorCritic(num_obs, num_actions, feat, generator,
                       encoder=(mod.MODULE, module))


def _has_file(name: str) -> bool:
    """Whether ``models/<name>.py`` builds the encoder block ``name``
    (this file and private ones build none)."""
    return (name.isidentifier() and not name.startswith("_")
            and name != "actor_critic" and (HERE / f"{name}.py").is_file())


def neglogp(x, mu, sigma, logstd):
    """Diagonal-Gaussian negative log prob."""
    return (0.5 * torch.sum(torch.square((x - mu) / sigma), dim=-1)
            + 0.5 * math.log(2.0 * math.pi) * x.shape[-1]
            + torch.sum(logstd, dim=-1))


def entropy(logstd):
    """sum(logstd) + 0.5*A*log(2*pi*e) (rl_games' convention)."""
    a = logstd.shape[-1]
    return torch.sum(logstd, dim=-1) + 0.5 * a * (1.0 + math.log(2.0 * math.pi))
