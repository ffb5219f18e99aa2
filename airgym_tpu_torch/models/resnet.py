"""ResNet-18 depth-image feature extractor (counterpart of
airgym_tpu/models/resnet.py).

The standard ResNet-18 topology (BasicBlock x [2, 2, 2, 2]) on a
1-channel 7 x 7 stem, max-pool 3 / 2 / 1, a global mean pool and an ``fc``
to ``output_dim``. The batch norms are ``FrozenBatchNorm`` (eval mode,
imported running stats). The backbone is frozen: it runs under
``torch.no_grad()`` with ``requires_grad`` off, so only ``fc`` trains, as
the JAX package's ``stop_gradient`` leaves it.

Parameter names follow torchvision's ``resnet18`` state dict (``conv1``,
``bn1``, ``layerK.J.{conv1,bn1,conv2,bn2}``, ``layerK.0.downsample.{0,1}``,
``fc``), so ``import_torchvision_state_dict`` is a copy with ``conv1``
summed over RGB. Input [B, 1, W, H] in the env's layout; the conv's first
spatial axis is the camera's width, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from airgym_tpu_torch.models.actor_critic import (FrozenBatchNorm,
                                                  _lecun_normal_)

# images per backbone call: bounds the stem's activations (64 x 106 x 60
# float32 per image, 1.6 MB) to ~1.7 GB a chunk at the rollout's 4096
ENCODE_CHUNK = 1024

_STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))


def _conv(cin: int, cout: int, k: int, stride: int, pad: int,
          generator: Optional[torch.Generator]) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, k, stride, pad, bias=False)
    _lecun_normal_(conv.weight, 1.0, generator)
    return conv


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = _conv(cin, cout, 3, stride, 1, generator)
        self.bn1 = FrozenBatchNorm(cout)
        self.conv2 = _conv(cout, cout, 3, 1, 1, generator)
        self.bn2 = FrozenBatchNorm(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                _conv(cin, cout, 1, stride, 0, generator),
                FrozenBatchNorm(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + identity)


class ResNet18Encoder(nn.Module):
    """[B, 1, W, H] depth image -> [B, output_dim] features."""

    def __init__(self, output_dim: int = 30,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = _conv(1, 64, 7, 2, 3, generator)
        self.bn1 = FrozenBatchNorm(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin = 64
        for k, (cout, stride) in enumerate(_STAGES, start=1):
            setattr(self, f"layer{k}", nn.Sequential(
                BasicBlock(cin, cout, stride, generator),
                BasicBlock(cout, cout, 1, generator)))
            cin = cout
        self.fc = nn.Linear(512, output_dim)
        _lecun_normal_(self.fc.weight, 1.0, generator)
        nn.init.zeros_(self.fc.bias)
        for name, p in self.named_parameters():
            if not name.startswith("fc."):
                p.requires_grad_(False)

    @torch.no_grad()
    def backbone(self, x: torch.Tensor) -> torch.Tensor:
        """Pooled [B, 512] features of the frozen backbone."""
        out = []
        for xc in x.split(ENCODE_CHUNK):
            y = self.maxpool(torch.relu(self.bn1(self.conv1(xc))))
            y = self.layer4(self.layer3(self.layer2(self.layer1(y))))
            out.append(torch.mean(y, dim=(2, 3)))
        return torch.cat(out)

    @property
    def head(self) -> nn.Module:
        """The trained part, applied last: the frozen backbone's pooled
        features are its input (``ActorCritic.frozen_head``)."""
        return self.fc

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.backbone(x))


def import_torchvision_state_dict(sd: Dict[str, Any], output_dim: int = 30,
                                  generator: Optional[torch.Generator] = None
                                  ) -> Dict[str, torch.Tensor]:
    """torchvision resnet18 state dict -> a ``ResNet18Encoder`` state dict.

    ``conv1`` is summed over RGB to one channel (the JAX package's gray
    adaptation); the ``fc`` head is freshly initialised from
    ``generator``. The batch norms' ``num_batches_tracked`` are zero where
    the file has none."""
    fresh = ResNet18Encoder(output_dim, generator=generator).state_dict()
    out = {}
    for k, v in fresh.items():
        if k.startswith("fc."):
            out[k] = v
        elif k == "conv1.weight":
            out[k] = torch.as_tensor(sd[k]).float().sum(1, keepdim=True)
        elif k in sd:
            out[k] = torch.as_tensor(sd[k]).to(v.dtype).reshape(v.shape)
        elif k.endswith("num_batches_tracked"):
            out[k] = v
        else:
            raise KeyError(f"resnet18 state dict lacks {k!r}")
    return out
