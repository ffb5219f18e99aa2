"""Depth-image VAE (counterpart of airgym_tpu/models/vae.py).

A ResNet8-style encoder with two skip branches -> 2 * latent (mean ++
logvar), a dense + five transposed-conv decoder, and the RL-side frozen
encoder (``VAEEncoder``: resize to (120, 212), return the means). Layer
geometry, paddings and the reference's center-crop quirk are those of
the JAX package: with a 120 x 212 input the second skip branch crops to
width 1 (a negative offset under torch slice semantics) and
broadcast-adds across the feature map.

Layout: NCHW throughout, torch's own; parameter names are the torch
``vae_model.pth``'s (``encoder.convN.*``, ``encoder.dense{0,1}.*``,
``img_decoder.dense.*``, ``img_decoder.dense1.*``,
``img_decoder.deconvN.*`` with ``ConvTranspose2d`` weights [I, O, k, k]),
so ``import_torch_state_dict`` is ``clean_state_dict`` and a copy.

Both resizes (the input to (120, 212), the decoder's 208 x 112 output to
(120, 212)) are bilinear with antialiasing, as ``jax.image.resize``
does when it shrinks an axis (each of them shrinks one): the JAX
package's semantics, which the port is held to.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.nn import functional as F

from airgym_tpu_torch.models.actor_critic import _lecun_normal_

IMAGE_RES = (120, 212)   # reference YAML vae.image_res


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """[N, C, h, w] -> [N, C, *size]: ``jax.image.resize(...,
    'bilinear')``, whose triangle kernel widens by the scale where an axis
    shrinks (antialiasing)."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=True)


def to_image_res(img: torch.Tensor) -> torch.Tensor:
    """[N, 1, W=212, H=120] env layout -> [N, 1, 120, 212] (the reference
    wrapper's interpolation, distortion included)."""
    return resize_bilinear(img, IMAGE_RES)


def _center_crop_torch(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """The reference ImgEncoder.center_crop under torch slice semantics,
    including the negative-offset quirk (x: NCHW)."""
    h, w = x.shape[2], x.shape[3]

    def slc(size, start, want):
        if start < 0:
            start = size + start          # torch negative index
        return start, min(start + want, size)

    h0, h1 = slc(h, (h - th) // 2, th)
    w0, w1 = slc(w, (w - tw) // 2, tw)
    return x[:, :, h0:h1, w0:w1]


def _init_(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Lecun-normal weights (fan in = a weight's trailing size), zero
    biases. A trained VAE's weights come from its file."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            _lecun_normal_(m.weight, 1.0, generator)
            nn.init.zeros_(m.bias)


class ImgEncoder(nn.Module):
    """conv ladder + 2 skip convs -> dense 512 -> 2 * latent."""

    def __init__(self, latent_dim: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv0 = nn.Conv2d(1, 32, 5, 2, 2)
        self.conv0_1 = nn.Conv2d(32, 32, 3, 2, 2)
        self.conv1_0 = nn.Conv2d(32, 32, 5, 2, 1)
        self.conv1_1 = nn.Conv2d(32, 64, 3, 1, 1)
        self.conv0_jump_2 = nn.Conv2d(32, 64, 4, 2, 1)
        self.conv2_0 = nn.Conv2d(64, 64, 5, 2, 2)
        self.conv2_1 = nn.Conv2d(64, 128, 3, 2, 1)
        self.conv1_jump_3 = nn.Conv2d(64, 128, 5, 4, (2, 1))
        self.conv3_0 = nn.Conv2d(128, 128, 3, 1, 1)
        self.dense0 = nn.Linear(128 * 4 * 7, 512)
        self.dense1 = nn.Linear(512, 2 * latent_dim)
        _init_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [N, 1, 120, 212]
        x0_0 = self.conv0(x)
        x0_1 = F.elu(self.conv0_1(x0_0))
        x1_0 = self.conv1_0(x0_1)
        x1_1 = self.conv1_1(x1_0)
        j2 = _center_crop_torch(self.conv0_jump_2(x0_1), x1_1.shape[2],
                                x1_1.shape[3])
        x1_1 = F.elu(x1_1 + j2)
        x2_0 = self.conv2_0(x1_1)
        x2_1 = self.conv2_1(x2_0)
        j3 = _center_crop_torch(self.conv1_jump_3(x1_1), x2_1.shape[2],
                                x2_1.shape[3])
        x2_1 = F.elu(x2_1 + j3)         # broadcast add when j3 is 1 wide
        x3_0 = self.conv3_0(x2_1)
        h = F.elu(self.dense0(x3_0.flatten(1)))   # NCHW flatten
        return self.dense1(h)


class ImgDecoder(nn.Module):
    """dense -> [128, 13, 7] -> 5 transposed convs -> sigmoid -> bilinear
    resize to (120, 212)."""

    def __init__(self, latent_dim: int = 64, with_logits: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.with_logits = with_logits
        self.dense = nn.Linear(latent_dim, 512)
        self.dense1 = nn.Linear(512, 128 * 13 * 7)
        self.deconv1 = nn.ConvTranspose2d(128, 128, 3, 1, 1)
        self.deconv2 = nn.ConvTranspose2d(128, 64, 4, 2, 1)
        self.deconv3 = nn.ConvTranspose2d(64, 32, 4, 2, 1)
        self.deconv4 = nn.ConvTranspose2d(32, 16, 4, 2, 1)
        self.deconv5 = nn.ConvTranspose2d(16, 1, 4, 2, 1)
        _init_(self, generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.dense1(torch.relu(self.dense(z))).reshape(-1, 128, 13, 7)
        for deconv in (self.deconv1, self.deconv2, self.deconv3,
                       self.deconv4):
            x = torch.relu(deconv(x))
        x = self.deconv5(x)
        if not self.with_logits:
            x = torch.sigmoid(x)
        return resize_bilinear(x, IMAGE_RES)


class VAE(nn.Module):
    """encode -> reparametrize -> decode."""

    def __init__(self, latent_dim: int = 64, with_logits: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.latent_dim = latent_dim
        self.encoder = ImgEncoder(latent_dim, generator)
        self.img_decoder = ImgDecoder(latent_dim, with_logits, generator)

    def encode_params(self, img: torch.Tensor) -> torch.Tensor:
        """[N, 1, W=212, H=120] env layout -> the raw 2 * latent output."""
        return self.encoder(to_image_res(img))

    def forward(self, img: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """-> (recon [N, 1, 120, 212], mean, logvar, z). Without a
        generator eps is 0 (inference)."""
        z = self.encode_params(img)
        mean, logvar = z[:, :self.latent_dim], z[:, self.latent_dim:]
        std = torch.exp(0.5 * logvar)
        eps = (torch.randn(std.shape, generator=generator, device=std.device,
                           dtype=std.dtype)
               if generator is not None else torch.zeros_like(std))
        z_sampled = mean + eps * std
        return self.img_decoder(z_sampled), mean, logvar, z_sampled


class VAEEncoder(nn.Module):
    """The RL side's frozen encoder: the VAE encoder's means. Only the
    encoder is held (the policy never runs the decoder); its weights have
    ``requires_grad`` off and run under ``torch.no_grad()``. Nothing of it
    trains, so its trained head (``head``, ``ActorCritic.frozen_head``) is
    the identity."""

    def __init__(self, latent_dim: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.latent_dim = latent_dim
        self.encoder = ImgEncoder(latent_dim, generator)
        self.head = nn.Identity()
        self.requires_grad_(False)

    @torch.no_grad()
    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.head(self.encoder(to_image_res(img))[:, :self.latent_dim])


def clean_state_dict(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Strip 'module.' and rename 'dronet.' -> 'encoder.' like the
    reference loader."""
    return {k.replace("module.", "").replace("dronet.", "encoder."): v
            for k, v in sd.items()}


def import_torch_state_dict(sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A torch ``vae_model.pth`` state dict -> a ``VAE`` state dict (the
    names are the file's once cleaned)."""
    sd = clean_state_dict(sd)
    return {k: torch.as_tensor(v).float() for k, v in sd.items()
            if k.startswith(("encoder.", "img_decoder."))}


def vae_loss(recon, target, mean, logvar, kl_weight: float = 1.0):
    """Pixel MSE summed per image + KL(q || N(0, I)), batch means."""
    rec = torch.mean(torch.sum(torch.square(recon - target), dim=(1, 2, 3)))
    kl = -0.5 * torch.mean(torch.sum(1 + logvar - torch.square(mean)
                                     - torch.exp(logvar), dim=-1))
    return rec + kl_weight * kl, {"recon": rec, "kl": kl}
