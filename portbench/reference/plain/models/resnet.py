"""The ``resnet`` network block (``resnet: {type: resnet18, output_dim:
30}``): ResNet-18 in plain torch at float32, from He et al., "Deep
Residual Learning for Image Recognition" (arXiv:1512.03385) as
torchvision's ``resnet18`` builds it and AirGym v0.5.1 wraps it
(``lib/network/resnet.py``, ``ResNetFeatureExtractor``): a 7 x 7 / 2 stem
with batch norm and ReLU, a 3 / 2 / 1 max-pool, four stages of two
BasicBlocks (64, 128, 256, 512 channels; the first block of stages 2-4
strides 2 and has a 1 x 1 / 2 conv and batch norm on its shortcut), a
global pool and ``fc`` (512 -> ``output_dim``). The backbone is frozen:
``requires_grad`` is off on everything but ``fc`` and it runs under
``no_grad``, so the reference's Adam leaves it as it was.

Departures from torchvision's module, each as the configuration runs it:

- the stem takes one channel (the depth image), not three;
- the batch norms are frozen at their statistics and folded: y = x * s +
  t with s = weight / sqrt(running_var + 1e-5) and t = bias -
  running_mean * s in float32 (torchvision's eval-mode ``BatchNorm2d``
  computes (x - mean) / sqrt(var + eps) * weight + bias, the same map
  rounded otherwise);
- the global pool is the mean over the two spatial axes (torchvision's
  ``AdaptiveAvgPool2d(1)`` and flatten, the same mean);
- the backbone runs over blocks of ``CHUNK`` images: the stem's float32
  output is 1.6 MB an image at 212 x 120, so 4096 at once would take
  ~7 GB a tensor. Each image is computed alone, so the blocks change no
  value in exact arithmetic; the block is the program's, so that cuDNN
  meets the same batch shapes;
- the weights are seeded, not ImageNet's: every conv and ``fc`` weight
  lecun-normal, drawn in the order stem, ``layerK.J.{conv1, conv2,
  downsample}``, ``fc``; ``fc``'s bias 0; the batch norms at weight 1,
  bias 0, mean 0, variance 1.

The input is [B, 1, W, H]: the conv's first spatial axis is the camera's
width. The keys are torchvision's (``conv1``, ``bn1``, ``layerK.J.{conv1,
bn1, conv2, bn2, downsample.0, downsample.1}``, ``fc``), the batch norms'
``num_batches_tracked`` included.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from portbench.reference.plain.models.actor_critic import (FrozenBatchNorm,
                                                           _lecun_normal_)

MODULE = "actor_resnet"
# images per backbone call
CHUNK = 1024
# (channels, stride of the first block) of each stage
STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))


def _conv(cin: int, cout: int, k: int, stride: int,
          generator: Optional[torch.Generator]) -> nn.Conv2d:
    """torchvision's conv7x7 / conv3x3 / conv1x1: padding k // 2, no bias."""
    conv = nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)
    _lecun_normal_(conv.weight, 1.0, generator)
    return conv


class FrozenBatchNorm2d(FrozenBatchNorm):
    """The CNN's folded eval-mode batch norm with torchvision's
    ``BatchNorm2d`` keys (``num_batches_tracked`` too)."""

    def __init__(self, features: int):
        super().__init__(features)
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.int64))


class BasicBlock(nn.Module):
    """torchvision's BasicBlock: relu(bn2(conv2(relu(bn1(conv1(x))))) +
    shortcut(x)), the shortcut x or downsample(x)."""

    def __init__(self, cin: int, cout: int, stride: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.conv1 = _conv(cin, cout, 3, stride, generator)
        self.bn1 = FrozenBatchNorm2d(cout)
        self.conv2 = _conv(cout, cout, 3, 1, generator)
        self.bn2 = FrozenBatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                _conv(cin, cout, 1, stride, generator),
                FrozenBatchNorm2d(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class ResNet18(nn.Module):
    """[B, 1, W, H] depth images -> [B, output_dim] features."""

    def __init__(self, output_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = _conv(1, 64, 7, 2, generator)
        self.bn1 = FrozenBatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin = 64
        for k, (cout, stride) in enumerate(STAGES, start=1):
            setattr(self, f"layer{k}", nn.Sequential(
                BasicBlock(cin, cout, stride, generator),
                BasicBlock(cout, cout, 1, generator)))
            cin = cout
        self.fc = nn.Linear(512, output_dim)
        _lecun_normal_(self.fc.weight, 1.0, generator)
        nn.init.zeros_(self.fc.bias)
        for name, p in self.named_parameters():
            p.requires_grad_(name.startswith("fc."))

    @torch.no_grad()
    def backbone(self, x: torch.Tensor) -> torch.Tensor:
        """The frozen backbone's pooled [B, 512] features."""
        out = []
        for xc in x.split(CHUNK):
            y = self.maxpool(torch.relu(self.bn1(self.conv1(xc))))
            y = self.layer4(self.layer3(self.layer2(self.layer1(y))))
            out.append(torch.mean(y, dim=(2, 3)))
        return torch.cat(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.backbone(x))


def build(block: dict, generator: Optional[torch.Generator] = None):
    """The network's ``resnet`` block -> (ResNet18, its feature count).
    Only ``resnet18`` with seeded weights is built: a block that grafts a
    weights file (``model_file``) is refused."""
    kind = block.get("type", "resnet18")
    if kind != "resnet18" or block.get("model_file"):
        raise ValueError(f"the reference builds a seeded resnet18 only, got "
                         f"{block}")
    features = int(block.get("output_dim", 30))
    return ResNet18(features, generator), features
