"""Batched depth camera (counterpart of airgym_tpu/render/depth.py).

Camera model (reference X152b camera, planning_config.py:52-62): 212 x 120,
horizontal FOV 87 deg (vertical by aspect), far plane 5 m, mounted at
(0.15, 0, 0.1) in the body frame, looking along body +x with +z up.
Images are perpendicular (z-) depth in the layout [N, 1, W=212, H=120].

``render_depth`` is the plain, uncull'd renderer: a fold of
physics/scene.py's ray casts over the primitives, kept as the test oracle
of the fused kernel. ``render_and_process`` is what the tasks call: the
depth render plus the reference's post-processing (clamp at 4.5 m,
normalise, additive and multiplicative noise, an unnormalised random 5x5
blur) as one fused kernel on the card (render/raycast.py,
csrc/render_process.cu), its plain version on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from airgym_tpu_torch.math import rotations as rot
from airgym_tpu_torch.physics import scene as sc

BIG = sc.BIG


@dataclasses.dataclass(frozen=True)
class CameraCfg:
    width: int = 212
    height: int = 120
    horizontal_fov_deg: float = 87.0
    far_plane: float = 5.0
    depth_clamp: float = 4.5            # customized.py:403-404
    mount_pos: tuple = (0.15, 0.0, 0.1)
    channels: int = 1


def ray_grid(cfg: CameraCfg) -> np.ndarray:
    """Camera-frame ray directions [W, H, 3] (x fwd, y left, z up),
    unnormalised with x == 1."""
    w, h = cfg.width, cfg.height
    tan_h = np.tan(np.radians(cfg.horizontal_fov_deg) / 2.0)
    tan_v = tan_h * h / w
    u = (np.arange(w) + 0.5) / w
    v = (np.arange(h) + 0.5) / h
    y = tan_h * (1.0 - 2.0 * u)
    z = tan_v * (1.0 - 2.0 * v)
    yy, zz = np.meshgrid(y, z, indexing="ij")
    dirs = np.stack([np.ones_like(yy), yy, zz], axis=-1)
    return dirs.astype(np.float32)


class SceneForRender(NamedTuple):
    """Optional primitive sets, each batched [N, P, ...] or None."""
    cylinders: Optional[sc.Cylinders] = None
    spheres: Optional[sc.Spheres] = None
    boxes: Optional[sc.Boxes] = None
    ground: bool = False
    annuli: Optional[sc.Annuli] = None


def min_dist_scene(p: torch.Tensor, scene: SceneForRender) -> torch.Tensor:
    """Min distance from point(s) p [.., 3] to every scene primitive [..]
    (contact queries; the ground is left to the tasks)."""
    d = torch.full(p.shape[:-1], BIG, dtype=p.dtype, device=p.device)
    for prims, fn in ((scene.cylinders, sc.dist_to_cylinders),
                      (scene.spheres, sc.dist_to_spheres),
                      (scene.boxes, sc.dist_to_boxes),
                      (scene.annuli, sc.dist_to_annuli)):
        if prims is not None:
            d = torch.minimum(d, torch.amin(fn(p, prims), dim=-1))
    return d


def render_depth(cfg: CameraCfg, root_states: torch.Tensor,
                 scene: SceneForRender) -> torch.Tensor:
    """Raw z-depth images [N, W, H] (meters, BIG where nothing is hit)."""
    n = root_states.shape[0]
    q = root_states[:, 3:7]
    pos = root_states[:, 0:3]
    dev, dt = root_states.device, root_states.dtype

    dirs_cam = torch.as_tensor(ray_grid(cfg), device=dev).reshape(-1, 3)
    R = dirs_cam.shape[0]
    m = rot.quat_to_matrix(q)                                   # [N, 3, 3]
    dirs_w = torch.einsum("nij,rj->nri", m, dirs_cam)           # [N, R, 3]
    norm = torch.linalg.norm(dirs_w, dim=-1)
    dirs_u = dirs_w / norm[..., None]
    origin = pos + rot.quat_rotate(
        q, torch.tensor(cfg.mount_pos, dtype=dt, device=dev).expand(n, 3))
    o = origin[:, None, :].expand(n, R, 3)

    t_eu = torch.full((n, R), BIG, dtype=dt, device=dev)
    if scene.ground:
        t_eu = torch.minimum(t_eu, sc.ray_ground(o, dirs_u))
    for prims, fn in ((scene.cylinders, sc.ray_cylinders),
                      (scene.spheres, sc.ray_spheres),
                      (scene.boxes, sc.ray_boxes),
                      (scene.annuli, sc.ray_annuli)):
        if prims is None:
            continue
        # one primitive at a time: a running [N, R] minimum, never the
        # [N, R, P] product
        for p in range(prims.valid.shape[1]):
            one = type(prims)(*[a[:, p:p + 1] for a in prims])
            t_eu = torch.minimum(t_eu, fn(o, dirs_u, one))
    # euclidean t -> z-depth (the unnormalised direction has x == 1)
    return (t_eu / norm).reshape(n, cfg.width, cfg.height)


def render_and_process(cfg: CameraCfg, root_states: torch.Tensor,
                       scene: SceneForRender, seed) -> torch.Tensor:
    """Depth render + post-processing -> [N, 1, W, H], as one fused
    kernel on the card (render/raycast.render_process, culling at the
    clamp depth, which is exact for the clamped image).

    ``seed`` is the 32-bit base of the kernel's hash RNG (an int or a
    0-d integer tensor). Cameras taller than 126 rows have no fused
    kernel; the JAX package falls back to an unfused threefry pipeline
    there, which PyTorch cannot reproduce."""
    from airgym_tpu_torch.render import raycast
    if cfg.height > raycast.LANES - 2:
        raise NotImplementedError(
            f"camera height {cfg.height} > {raycast.LANES - 2}: the "
            f"unfused render pipeline for tall cameras is not ported, "
            f"ROADMAP.md queue A item 12c")
    return raycast.render_process(cfg, root_states, scene, seed,
                                  cull_far_z=cfg.depth_clamp)
