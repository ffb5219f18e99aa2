"""AssetManager: asset config -> per-env analytic scene and actor counts
(counterpart of airgym_tpu/assets/manager.py).

The reference's four include categories become primitive records for the
physics and the renderer:

  * include_robot         -> the controlled quadrotor(s) (counted only)
  * include_single_asset  -> fixed named primitives (balls, cubes, ...);
                             a ground board adds the z = 0 plane
  * include_group_asset   -> a random variant of a group family per slot
                             (thin trees, vtrees, objects, ...)
  * include_boundary      -> ground / walls (only the ground plane exists
                             in the shipped task configs)

A scene is drawn in two steps, so that a test can feed another
framework's draws to the composition: ``draw(rand, randint)`` takes the
placements, yaws and variants from the two samplers, and ``compose``
turns them into a ``SceneForRender`` and the env-asset root states
[N, K, 13] that back the privileged observations. ``sample_scene`` is
the two together.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from airgym_tpu_torch import assets as areg
from airgym_tpu_torch.physics import scene as sc
from airgym_tpu_torch.render import depth as dr


@dataclasses.dataclass(frozen=True)
class AssetConfig:
    include_robot: tuple = (("X152b", 1),)
    include_single_asset: tuple = ()       # ((name, count), ...)
    include_group_asset: tuple = ()
    include_boundary: tuple = ()
    placement_x: float = 8.0               # placement half-ranges
    placement_y: float = 4.0

    @staticmethod
    def from_dicts(include_robot: Dict[str, Dict] = None,
                   include_single_asset: Dict[str, Dict] = None,
                   include_group_asset: Dict[str, Dict] = None,
                   include_boundary: Dict[str, Dict] = None,
                   **kw) -> "AssetConfig":
        """Reference-style nested dicts -> a hashable config; only
        ``num_assets`` is read (primitive assets need no geometry
        overrides)."""
        def conv(d):
            return tuple((name, int(p.get("num_assets", 1)))
                         for name, p in (d or {}).items())

        return AssetConfig(
            include_robot=conv(include_robot) or (("X152b", 1),),
            include_single_asset=conv(include_single_asset),
            include_group_asset=conv(include_group_asset),
            include_boundary=conv(include_boundary), **kw)


class Placement(NamedTuple):
    """The draws of one include entry: positions in [-1, 1] before the
    placement half-ranges, yaws, and a group family's variants."""
    xy: torch.Tensor                         # [N, C, 2] in [-1, 1)
    yaw: torch.Tensor                        # [N, C]
    variant: Optional[torch.Tensor] = None   # [N, C] int64, groups only


class SceneDraws(NamedTuple):
    """One entry per include entry with a count above 0, in config order:
    ``single`` holds None for a ground board (it draws nothing)."""
    single: Tuple[Optional[Placement], ...]
    group: Tuple[Placement, ...]


# rand(*shape) -> U[0, 1) float draws; randint(high, *shape) -> [0, high)
Sampler = Callable[..., torch.Tensor]


class AssetManager:
    def __init__(self, cfg: AssetConfig, num_envs: int):
        self.cfg = cfg
        self.num_envs = num_envs

    # -- counts --------------------------------------------------------------

    def get_robot_count(self) -> int:
        return sum(c for _, c in self.cfg.include_robot)

    def get_env_asset_count(self) -> int:
        return (sum(c for _, c in self.cfg.include_single_asset)
                + sum(c for _, c in self.cfg.include_group_asset)
                + self.get_env_boundary_count())

    def get_env_boundary_count(self) -> int:
        return sum(c for _, c in self.cfg.include_boundary)

    def get_env_actor_count(self) -> int:
        return self.get_robot_count() + self.get_env_asset_count()

    def get_robot_num_bodies(self) -> int:
        # X152b: base + 4 props (model.urdf)
        return 5 * self.get_robot_count()

    # -- scene ---------------------------------------------------------------

    def draw(self, rand: Sampler, randint: Sampler) -> SceneDraws:
        """Every entry's draws, in config order: a single asset its
        positions then yaws, a group its variants, positions, yaws."""
        n = self.num_envs

        def place(count, variant=None):
            xy = rand(n, count, 2) * 2.0 - 1.0
            yaw = rand(n, count) * (2.0 * math.pi) - math.pi
            return Placement(xy=xy, yaw=yaw, variant=variant)

        single = []
        for name, count in self.cfg.include_single_asset:
            if count == 0:
                continue
            if areg.registry.get_asset(name).geometry == "plane":
                single.append(None)
            else:
                single.append(place(count))
        group = []
        for name, count in self.cfg.include_group_asset:
            if count == 0:
                continue
            variant = randint(areg.num_variants(name), n, count)
            group.append(place(count, variant))
        return SceneDraws(single=tuple(single), group=tuple(group))

    def compose(self, draws: SceneDraws
                ) -> Tuple[dr.SceneForRender, torch.Tensor]:
        """Draws -> (scene, env-asset root states [N, K, 13]): positions
        scaled by the placement half-ranges, single assets at their
        height, group families composed by ``assets.place_group``. A
        ground board adds only a zero root block; the scene always has the
        ground plane; the root states carry unit-w quaternions."""
        n = self.num_envs
        cyls, sphs, boxes, annuli, root_blocks = [], [], [], [], []
        some = [p for p in draws.single + draws.group if p is not None]
        dev = some[0].xy.device if some else None
        dt = some[0].xy.dtype if some else torch.float32
        scale = torch.tensor([self.cfg.placement_x, self.cfg.placement_y],
                             dtype=dt, device=dev)

        singles = [(name, count) for name, count
                   in self.cfg.include_single_asset if count]
        for (name, count), p in zip(singles, draws.single):
            if p is None:
                root_blocks.append(torch.zeros((n, count, 3), dtype=dt,
                                               device=dev))
                continue
            spec = areg.registry.get_asset(name)
            xy = p.xy * scale
            ones = torch.ones((n, count), dtype=dt, device=dev)
            if spec.geometry == "sphere":
                center = torch.cat([xy, ones[..., None]], dim=-1)
                sphs.append(sc.Spheres(center=center,
                                       radius=ones * spec.radius,
                                       valid=ones > 0))
                root_blocks.append(center)
            elif spec.geometry == "box":
                he = torch.tensor(spec.half_extents, dtype=dt, device=dev)
                center = torch.cat([xy, ones[..., None] * he[2]], dim=-1)
                boxes.append(sc.Boxes(center=center, yaw=p.yaw,
                                      half_extents=he.expand(n, count, 3),
                                      valid=ones > 0))
                root_blocks.append(center)

        groups = [(name, count) for name, count
                  in self.cfg.include_group_asset if count]
        for (name, count), p in zip(groups, draws.group):
            xy = p.xy * scale
            placed = areg.place_group(name, p.variant, xy, p.yaw)
            for parts, prims in ((cyls, placed.cylinders),
                                 (sphs, placed.spheres),
                                 (boxes, placed.boxes),
                                 (annuli, placed.annuli)):
                if prims is not None:
                    parts.append(prims)
            root_blocks.append(torch.cat(
                [xy, torch.zeros((n, count, 1), dtype=dt, device=dev)],
                dim=-1))

        def cat(parts, cls):
            if not parts:
                return None
            return cls(*[torch.cat(fields, dim=1) for fields in zip(*parts)])

        scene = dr.SceneForRender(
            cylinders=cat(cyls, sc.Cylinders), spheres=cat(sphs, sc.Spheres),
            boxes=cat(boxes, sc.Boxes), annuli=cat(annuli, sc.Annuli),
            ground=True)
        if root_blocks:
            pos = torch.cat(root_blocks, dim=1)
            states = torch.zeros((n, pos.shape[1], 13), dtype=dt,
                                 device=dev)
            states[..., 0:3] = pos
            states[..., 6] = 1.0
        else:
            states = torch.zeros((n, 0, 13), dtype=dt, device=dev)
        return scene, states

    def sample_scene(self, rand: Sampler, randint: Sampler
                     ) -> Tuple[dr.SceneForRender, torch.Tensor]:
        return self.compose(self.draw(rand, randint))
