"""Asset constants and tree geometry (counterpart of
airgym_tpu/assets/__init__.py).

What the ported tasks read: the robot's ground-collision radius, and the
thin-tree table Planning's forest is built from (``thin_trees.npy``, the
per-variant collision cylinder of the 100 reference tree URDFs, a copy of
the JAX package's table). The asset registry and the other geometry
tables are ROADMAP.md queue A item 11.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from airgym_tpu_torch.physics import scene as sc

ROBOT_COLLISION_RADIUS = 0.2  # X152b/model.urdf:16

_ASSET_DIR = os.path.dirname(os.path.abspath(__file__))
_TREE_TABLE = None


def thin_tree_table() -> np.ndarray:
    """[100, 8] = (radius, length, ox, oy, oz, roll, pitch, yaw) per
    reference tree URDF variant."""
    global _TREE_TABLE
    if _TREE_TABLE is None:
        _TREE_TABLE = np.load(os.path.join(_ASSET_DIR, "thin_trees.npy"))
    return _TREE_TABLE


def tree_cylinders_from_placement(variant_idx: torch.Tensor,
                                  pos_xy: torch.Tensor,
                                  yaw: torch.Tensor) -> sc.Cylinders:
    """World-frame cylinders from per-slot variant + placement.

    variant_idx [N, P] int, pos_xy [N, P, 2], yaw [N, P]: a tree URDF
    placed at (x, y, 0) with a random z rotation. URDF rpy is extrinsic
    XYZ and trees have roll 0, so the axis is Rz(yaw_total) (sin p, 0,
    cos p)."""
    table = torch.as_tensor(thin_tree_table(), device=pos_xy.device)
    row = table[variant_idx.long()]                  # [N, P, 8]
    radius, length = row[..., 0], row[..., 1]
    off = row[..., 2:5]
    pitch, uyaw = row[..., 6], row[..., 7]

    cy, sy = torch.cos(yaw), torch.sin(yaw)
    ox = cy * off[..., 0] - sy * off[..., 1]
    oy = sy * off[..., 0] + cy * off[..., 1]
    center = torch.stack(
        [pos_xy[..., 0] + ox, pos_xy[..., 1] + oy, off[..., 2]], dim=-1)

    total_yaw = yaw + uyaw
    sp, cp = torch.sin(pitch), torch.cos(pitch)
    axis = torch.stack([torch.cos(total_yaw) * sp,
                        torch.sin(total_yaw) * sp, cp], dim=-1)
    valid = torch.ones(radius.shape, dtype=torch.bool, device=radius.device)
    return sc.Cylinders(center=center, axis=axis, half_len=length / 2.0,
                        radius=radius, valid=valid)
