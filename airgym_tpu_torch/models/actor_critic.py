"""Actor-critic model (counterpart of airgym_tpu/models/actor_critic.py).

Continuous A2C model with a global state-independent log-std
(``fixed_sigma: True`` by default), a shared MLP trunk ([64,128,64] elu
by default), and mu / value heads initialized at 0.1x scale. Parameter
names follow the reference .pth keys: ``actor_mlp.layers.N.{weight,
bias}``, ``mu.*``, ``value_head.*``, ``logstd``; a torch Linear weight is
[out, in], which is also the feature-major layout the fused kernels read.

Camera tasks add an image encoder (``image_encoder``): the depth image
[B, 1, W, H] is normalised per pixel and encoded, and the MLP reads
[observation ++ features], normalised by the 'observation' running
stats. 'cnn' (``actor_cnn``, 30 features): keys
``actor_cnn.features.{0,3,6}`` (convs), ``.features.{2,5,8}`` (batch
norms) and ``actor_cnn.fc``; ``cnn_impl='pallas'`` runs the conv stack in
the fused kernels of ``experiments/fused_cnn.py`` on the same parameters.
'vae' (``actor_enc``, ``vae_latent_dim`` features, ``models/vae.py``) and
'resnet' (``actor_resnet``, ``image_feature_dim`` features,
``models/resnet.py``) are frozen where the JAX package stops the
gradient: the whole VAE encoder, the ResNet's backbone (its ``fc``
trains). Their parameters have ``requires_grad`` off, and the trainer's
Adam leaves them out (JAX's Adam sees zero gradients there and leaves
them unchanged; the clip's norm counts zeros).

Options of the reference ``network:`` block: ``activation`` (elu, relu,
tanh, sigmoid, sin, none), ``separate`` (a ``critic_mlp`` trunk of the same
units on the same normalised input feeds the value head; refused with
images, as the JAX package refuses it) and ``fixed_sigma: False`` (a
linear ``logstd`` head on the actor trunk, weight and bias zero, so sigma
starts at exactly 1; its keys are ``logstd.weight`` / ``logstd.bias``).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from airgym_tpu_torch.experiments import fused_cnn

CNN_IMPLS = ("auto", "xla", "pallas")
IMAGE_ENCODERS = (None, "cnn", "vae", "resnet")
# the encoders' module names, as in the JAX package's parameter tree
ENCODER_MODULES = {"cnn": "actor_cnn", "vae": "actor_enc",
                   "resnet": "actor_resnet"}
SEPARATE_WITH_IMAGES = (
    "separate: True with image observations is not supported (the "
    "reference's own branch is broken, a2c_continuous_logstd_model.py:85-95)")
ACTIVATIONS = {
    "elu": nn.functional.elu,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "sin": torch.sin,
    "none": lambda x: x,
}


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
    """Trunk of ``activation`` after every layer; ``layers.N`` are the
    reference's key names."""

    def __init__(self, in_dim: int, units: Sequence[int],
                 activation: str = "elu"):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"activation must be one of "
                             f"{sorted(ACTIVATIONS)}, got {activation!r}")
        self.act = ACTIVATIONS[activation]
        dims = [in_dim, *units]
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = self.act(layer(x))
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

    def folded(self):
        """(s, t) in float32; the running stats get no gradient."""
        s = self.weight * torch.rsqrt(self.running_var + 1e-5)
        return s, self.bias - self.running_mean * s

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s, t = self.folded()
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


def fold_conv0(weight: torch.Tensor, bias: torch.Tensor):
    """conv0 [16, 1, 5, 5] -> (w0 [64, 64], b0 [64]): the JAX package's
    ``_FoldedConv0(return_matrix=True)``. Rows (cell a, cell b, s2d channel
    2p + q), columns (output pixel parity, filter); b0 is the bias tiled
    x4. Autograd carries the matrix's gradient back to the weight."""
    k = weight.permute(2, 3, 1, 0)                        # HWIO [5, 5, 1, F]
    f = k.shape[-1]
    wk = nn.functional.pad(k, (0, 0, 0, 0, 0, 1, 0, 1))  # [6, 6, 1, F]
    wk = wk.reshape(3, 2, 3, 2, f).permute(0, 2, 1, 3, 4).reshape(3, 3, 4, f)
    cols = [nn.functional.pad(wk, (0, 0, 0, 0, q, 1 - q, p, 1 - p))
            for p in (0, 1) for q in (0, 1)]
    return torch.stack(cols, dim=-2).reshape(64, 4 * f), torch.tile(bias, (4,))


def fold_conv1(weight: torch.Tensor) -> torch.Tensor:
    """conv1 [32, 16, 3, 3] -> w1 [256, 32]: the JAX package's
    ``_CellConv1(return_matrix=True)``, a 2 x 2-cell stride-1 conv over
    the folded conv0 layout; rows (cell a, cell b, folded channel)."""
    k = weight.permute(2, 3, 1, 0)                        # HWIO [3, 3, Ci, F]
    cin, f = k.shape[2], k.shape[3]
    kp = nn.functional.pad(k, (0, 0, 0, 0, 1, 0, 1, 0))  # index = dy + 1
    w = kp.reshape(2, 2, 2, 2, cin, f)                    # [a, p, b, q, Ci, F]
    return w.permute(0, 2, 1, 3, 4, 5).reshape(16 * cin, f)


class CNNEncoder(nn.Module):
    """Depth-image feature extractor, layer for layer the reference
    CNNFeatureExtractor: conv(16,5,s2) -> ReLU -> BN, conv(32,3,s2) -> ReLU
    -> BN, conv(64,3,s2) -> ReLU -> BN, global mean pool in float32,
    fc(64 -> feature_dim). Input [B, C, W, H] in the JAX package's layout
    (the camera's width is the conv's first spatial axis).

    ``compute_dtype`` bfloat16 (default) runs the convs in bf16 with float32
    parameters; None runs them in float32.

    ``impl``: 'auto' or 'xla' (the default) sends the convolutions to cuDNN
    on the card; 'pallas' runs the whole stack up to the pool in the fused
    kernels of ``experiments/fused_cnn.py`` (plain versions on the CPU),
    with the weights folded here, and needs H and W divisible by 4. Both
    use the same parameters. 'pallas_interpret' is the JAX package's
    interpret mode: here 'pallas' on a CPU tensor is its counterpart."""

    def __init__(self, in_channels: int = 1, feature_dim: int = 30,
                 compute_dtype=torch.bfloat16,
                 generator: Optional[torch.Generator] = None,
                 impl: str = "auto"):
        super().__init__()
        if impl == "pallas_interpret":
            raise ValueError("impl='pallas_interpret' is the JAX package's "
                             "interpret mode; use impl='pallas' on a CPU "
                             "tensor, which runs the plain versions")
        if impl not in CNN_IMPLS:
            raise ValueError(f"impl must be one of {CNN_IMPLS}, got {impl!r}")
        self.compute_dtype = compute_dtype
        self.impl = impl
        self.features = nn.Sequential(
            _Conv(in_channels, 16, 5), nn.ReLU(), FrozenBatchNorm(16),
            _Conv(16, 32, 3), nn.ReLU(), FrozenBatchNorm(32),
            _Conv(32, 64, 3), nn.ReLU(), FrozenBatchNorm(64))
        self.fc = nn.Linear(64, feature_dim)
        for conv in (self.features[0], self.features[3], self.features[6]):
            _lecun_normal_(conv.weight, 1.0, generator)
        _lecun_normal_(self.fc.weight, 1.0, generator)
        nn.init.zeros_(self.fc.bias)

    def fused_weights(self):
        """The fused kernels' 12 inputs, folded from the parameters."""
        f = self.features
        w0, b0 = fold_conv0(f[0].weight, f[0].bias)
        s0, t0 = f[2].folded()
        s1, t1 = f[5].folded()
        s2, t2 = f[8].folded()
        return {"w0": w0, "b0": b0, "s0": torch.tile(s0, (4,)),
                "t0": torch.tile(t0, (4,)), "w1": fold_conv1(f[3].weight),
                "b1": f[3].bias, "s1": s1, "t1": t1,
                "w2": f[6].weight.permute(2, 3, 1, 0).reshape(288, 64),
                "b2": f[6].bias, "s2": s2, "t2": t2}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        if self.impl == "pallas":
            # [B, 1, W, H] -> the JAX package's NHWC [B, W, H, 1]
            pooled = fused_cnn.encode_pooled(x.permute(0, 2, 3, 1),
                                             self.fused_weights())
            return self.fc(pooled)
        x = self.features(x)
        return self.fc(torch.mean(x.to(torch.float32), dim=(2, 3)))


class ActorCritic(nn.Module):
    """Actor-critic with a shared (or ``separate``) trunk and a fixed (or
    state-dependent) log-std.

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
                 image_feature_dim: int = 30, vae_latent_dim: int = 64,
                 cnn_compute_dtype=torch.bfloat16, cnn_impl: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if image_encoder not in IMAGE_ENCODERS:
            raise ValueError(f"image_encoder must be one of "
                             f"{IMAGE_ENCODERS}, got {image_encoder!r}")
        if separate and image_encoder is not None:
            raise ValueError(SEPARATE_WITH_IMAGES)
        self.units = tuple(units)
        self.activation = activation
        self.separate = separate
        self.fixed_sigma = fixed_sigma
        self.image_encoder = image_encoder
        self.image_features = 0
        if image_encoder == "cnn":
            self.actor_cnn = CNNEncoder(feature_dim=image_feature_dim,
                                        compute_dtype=cnn_compute_dtype,
                                        generator=generator, impl=cnn_impl)
            self.image_features = image_feature_dim
        elif image_encoder == "vae":
            from airgym_tpu_torch.models.vae import VAEEncoder
            self.actor_enc = VAEEncoder(vae_latent_dim, generator=generator)
            self.image_features = vae_latent_dim
        elif image_encoder == "resnet":
            from airgym_tpu_torch.models.resnet import ResNet18Encoder
            self.actor_resnet = ResNet18Encoder(image_feature_dim,
                                                generator=generator)
            self.image_features = image_feature_dim
        in_dim = num_obs + self.image_features
        self.actor_mlp = MLP(in_dim, units, activation)
        trunks = [self.actor_mlp]
        if separate:
            self.critic_mlp = MLP(in_dim, units, activation)
            trunks.append(self.critic_mlp)
        self.mu = nn.Linear(units[-1], num_actions)
        self.value_head = nn.Linear(units[-1], 1)
        if fixed_sigma:
            self.logstd = nn.Parameter(torch.zeros(num_actions))
        else:
            self.logstd = nn.Linear(units[-1], num_actions)
            nn.init.zeros_(self.logstd.weight)
            nn.init.zeros_(self.logstd.bias)
        for trunk in trunks:
            for layer in trunk.layers:
                _lecun_normal_(layer.weight, 1.0, generator)
                nn.init.zeros_(layer.bias)
        for head in (self.mu, self.value_head):
            _lecun_normal_(head.weight, 0.1, generator)
            nn.init.zeros_(head.bias)

    @property
    def encoder(self) -> Optional[nn.Module]:
        """The image encoder module, or None."""
        if self.image_encoder is None:
            return None
        return getattr(self, ENCODER_MODULES[self.image_encoder])

    def encode_image(self, img: torch.Tensor, obs_rms=None) -> torch.Tensor:
        """Camera frames [B, 1, W, H] (any float dtype) -> features; the
        per-pixel normalisation runs in float32."""
        img = img.to(torch.float32)
        if obs_rms is not None:
            img = obs_rms["image"].normalize(img)
        return self.encoder(img)

    def encode(self, obs, obs_rms=None):
        """-> (MLP input after normalization, pre-normalization vector,
        which the trainer feeds to the running stats)."""
        if isinstance(obs, dict):
            if self.separate:
                raise ValueError(SEPARATE_WITH_IMAGES)
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
        if self.fixed_sigma:
            sigma = torch.exp(self.logstd) * torch.ones_like(mu)
        else:
            sigma = torch.exp(self.logstd(h))
        value = self.value_head(self.critic_mlp(x) if self.separate else h)
        if return_prenorm:
            return mu, sigma, value, prenorm
        return mu, sigma, value


def neglogp(x, mu, sigma, logstd):
    """Diagonal-Gaussian negative log prob."""
    return (0.5 * torch.sum(torch.square((x - mu) / sigma), dim=-1)
            + 0.5 * math.log(2.0 * math.pi) * x.shape[-1]
            + torch.sum(logstd, dim=-1))


def entropy(logstd):
    """sum(logstd) + 0.5*A*log(2*pi*e) (rl_games' convention)."""
    a = logstd.shape[-1]
    return torch.sum(logstd, dim=-1) + 0.5 * a * (1.0 + math.log(2.0 * math.pi))
