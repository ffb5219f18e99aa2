"""The scene primitives Planning renders: tilted finite cylinders (tree
trunks) and spheres (the goal ball), each batched [N, P, ...], beside the
ground plane. The render's plain version (render/raycast.py) casts rays
against them record by record; ``BIG`` stands for no hit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

BIG = 1e9


class Cylinders(NamedTuple):
    """Finite cylinders: center [.., P, 3], unit axis [.., P, 3],
    half_len [.., P], radius [.., P], valid [.., P] (bool)."""
    center: torch.Tensor
    axis: torch.Tensor
    half_len: torch.Tensor
    radius: torch.Tensor
    valid: torch.Tensor


class Spheres(NamedTuple):
    center: torch.Tensor       # [.., P, 3]
    radius: torch.Tensor       # [.., P]
    valid: torch.Tensor        # [.., P]
