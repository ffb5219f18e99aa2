"""Batched depth camera, as Planning renders it.

Camera model (reference X152b camera, planning_config.py:52-62): 212 x 120,
horizontal FOV 87 deg (vertical by aspect), far plane 5 m, mounted at
(0.15, 0, 0.1) in the body frame, looking along body +x with +z up.
Images are perpendicular (z-) depth in the layout [N, 1, W=212, H=120].
``render_and_process`` is the depth render plus the reference's
post-processing (clamp at 4.5 m, normalise, additive and multiplicative
noise, an unnormalised random 5x5 blur): the plain version of the fused
kernel csrc/render_process.cu (render/raycast.py).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from portbench.reference.plain.physics import scene as sc


@dataclasses.dataclass(frozen=True)
class CameraCfg:
    width: int = 212
    height: int = 120
    horizontal_fov_deg: float = 87.0
    far_plane: float = 5.0
    depth_clamp: float = 4.5            # customized.py:403-404
    mount_pos: tuple = (0.15, 0.0, 0.1)
    channels: int = 1


class SceneForRender(NamedTuple):
    """The primitive sets, each batched [N, P, ...], and the ground."""
    cylinders: sc.Cylinders
    spheres: sc.Spheres
    ground: bool = True


def render_and_process(cfg: CameraCfg, root_states: torch.Tensor,
                       scene: SceneForRender, seed) -> torch.Tensor:
    """Depth render + post-processing -> [N, 1, W, H], culling at the
    clamp depth, which is exact for the clamped image. ``seed`` is the
    32-bit base of the hash RNG (an int or a 0-d integer tensor)."""
    from portbench.reference.plain.render import raycast
    if cfg.height > raycast.LANES - 2:
        raise ValueError(f"the fused render + process covers cameras of at "
                         f"most {raycast.LANES - 2} rows")
    return raycast.render_process(cfg, root_states, scene, seed,
                                  cull_far_z=cfg.depth_clamp)
