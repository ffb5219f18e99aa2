"""Asset registry and geometry tables (counterpart of
airgym_tpu/assets/__init__.py).

The registry (``AssetSpec``, ``registry``) names every reference asset
with the analytic geometry the physics and the renderer use in its place
(the X152b's 0.2 m collision sphere, the 0.3 m cube, the ground boards as
the z = 0 plane). The per-variant primitive tables of the group families
are copies of the JAX package's: ``thin_trees.npy`` (the collision
cylinder of each of the 100 thin-tree URDFs), ``vtrees.npy`` (the 13
cylinders of each of the 100 tree variants), ``tree_mesh.npz`` (cylinder
skeleton and leaf spheres of the tree mesh), ``cubes.npy``, ``flags.npz``
and ``objects.npy`` (one box or sphere per object variant).
``place_group`` composes a family's primitives with per-slot (variant, x,
y, yaw) placements; ``sample_tree_scene`` draws a random thin-tree forest.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from airgym_tpu_torch.physics import scene as sc

THIN_SEMANTIC_ID = 1
VTREE_SEMANTIC_ID = 2
OBJECT_SEMANTIC_ID = 3
CUBE_SEMANTIC_ID = 4
FLAG_SEMANTIC_ID = 5
TREE_SEMANTIC_ID = 6
BALL_SEMANTIC_ID = 7
GROUND_SEMANTIC_ID = 8

ROBOT_COLLISION_RADIUS = 0.2  # X152b/model.urdf:16

_ASSET_DIR = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass(frozen=True)
class AssetSpec:
    """What the analytic backend reads of a reference asset."""
    name: str
    asset_type: str              # robot | single | group | boundary
    semantic_id: int = 0
    geometry: str = "sphere"     # sphere | cylinder_table | box | plane | family
    radius: float = 0.0
    half_extents: tuple = (0.5, 0.5, 0.5)
    fix_base_link: bool = True
    collision_mask: int = 1
    num_assets: int = 1


class AssetRegistry:
    def __init__(self):
        self._assets: Dict[str, AssetSpec] = {}

    def register_asset(self, name: str, spec: AssetSpec) -> None:
        self._assets[name] = spec

    def get_asset(self, name: str) -> AssetSpec:
        return self._assets[name]

    def names(self):
        return sorted(self._assets)


registry = AssetRegistry()

registry.register_asset("X152b", AssetSpec(
    name="X152b", asset_type="robot", geometry="sphere", radius=0.2,
    fix_base_link=False))
registry.register_asset("thin", AssetSpec(
    name="thin", asset_type="group", semantic_id=THIN_SEMANTIC_ID,
    geometry="cylinder_table"))
registry.register_asset("vtrees", AssetSpec(
    name="vtrees", asset_type="group", semantic_id=VTREE_SEMANTIC_ID,
    geometry="cylinder_table"))
registry.register_asset("trees", AssetSpec(
    name="trees", asset_type="group", semantic_id=TREE_SEMANTIC_ID,
    geometry="cylinder_table"))
registry.register_asset("balls/ball", AssetSpec(
    name="balls/ball", asset_type="single", semantic_id=BALL_SEMANTIC_ID,
    geometry="sphere", radius=0.2))
registry.register_asset("balls/balloon", AssetSpec(
    name="balls/balloon", asset_type="single", semantic_id=BALL_SEMANTIC_ID,
    geometry="sphere", radius=0.2))
registry.register_asset("cubes/1x1", AssetSpec(
    name="cubes/1x1", asset_type="single", semantic_id=CUBE_SEMANTIC_ID,
    # the mesh is a 0.3 m cube
    geometry="box", half_extents=(0.15, 0.15, 0.15), fix_base_link=False))
registry.register_asset("grounds/ground", AssetSpec(
    name="grounds/ground", asset_type="boundary",
    semantic_id=GROUND_SEMANTIC_ID, geometry="plane"))
# group families backed by per-variant geometry tables (family_geometry)
registry.register_asset("objects", AssetSpec(
    name="objects", asset_type="group", semantic_id=OBJECT_SEMANTIC_ID,
    geometry="family"))
registry.register_asset("cubes", AssetSpec(
    name="cubes", asset_type="group", semantic_id=CUBE_SEMANTIC_ID,
    geometry="family"))
registry.register_asset("balls", AssetSpec(
    name="balls", asset_type="group", semantic_id=BALL_SEMANTIC_ID,
    geometry="family"))
registry.register_asset("flags", AssetSpec(
    name="flags", asset_type="group", semantic_id=FLAG_SEMANTIC_ID,
    geometry="family"))
# textured ground boards: rendered and collided as the z = 0 plane;
# half_extents record the board's footprint
registry.register_asset("8x18ground", AssetSpec(
    name="8x18ground", asset_type="single",
    semantic_id=GROUND_SEMANTIC_ID, geometry="plane",
    half_extents=(4.0, 9.0, 0.0)))
for _g in ("18x18ground", "18x18o", "18x18s"):
    registry.register_asset(_g, AssetSpec(
        name=_g, asset_type="single", semantic_id=GROUND_SEMANTIC_ID,
        geometry="plane", half_extents=(9.0, 9.0, 0.0)))


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


# ---------------------------------------------------------------------------
# per-family multi-primitive tables, in the z-up asset frame


class FamilyGeom(NamedTuple):
    """Per-variant primitive tables, all [V, P, k] with a trailing valid
    column (0 on padding rows)."""
    cyls: Optional[np.ndarray] = None     # [V, C, 9] center axis radius half_len valid
    boxes: Optional[np.ndarray] = None    # [V, B, 7] center half_extents valid
    sphs: Optional[np.ndarray] = None     # [V, S, 5] center radius valid
    annuli: Optional[np.ndarray] = None   # [V, A, 10] center normal r_in r_out half_thick valid


_FAMILY_CACHE: Dict[str, FamilyGeom] = {}


def _load(name):
    return np.load(os.path.join(_ASSET_DIR, name))


def family_geometry(family: str) -> FamilyGeom:
    """Geometry tables of a group-asset family."""
    if family in _FAMILY_CACHE:
        return _FAMILY_CACHE[family]
    if family == "thin":
        t = thin_tree_table()
        radius, length = t[:, 0], t[:, 1]
        off = t[:, 2:5]
        pitch, uyaw = t[:, 6], t[:, 7]
        axis = np.stack([np.cos(uyaw) * np.sin(pitch),
                         np.sin(uyaw) * np.sin(pitch),
                         np.cos(pitch)], axis=-1)
        cyls = np.concatenate(
            [off, axis, radius[:, None], length[:, None] / 2,
             np.ones((len(t), 1))], axis=-1)[:, None, :]
        geom = FamilyGeom(cyls=cyls.astype(np.float32))
    elif family == "vtrees":
        v = _load("vtrees.npy")                    # [100, 13, 8]
        valid = np.ones(v.shape[:2] + (1,), np.float32)
        geom = FamilyGeom(cyls=np.concatenate([v, valid], axis=-1))
    elif family == "trees":
        z = _load("tree_mesh.npz")
        c, s = z["cylinders"], z["spheres"]        # [12, 8], [24, 4]
        cyls = np.concatenate(
            [c, np.ones((len(c), 1), np.float32)], axis=-1)[None]
        sphs = np.concatenate(
            [s, np.ones((len(s), 1), np.float32)], axis=-1)[None]
        geom = FamilyGeom(cyls=cyls, sphs=sphs)
    elif family == "cubes":
        geom = FamilyGeom(boxes=_load("cubes.npy"))       # [8, 4, 7]
    elif family == "flags":
        z = _load("flags.npz")
        ann = z["annuli"].copy()
        # the ring panels are zero-thickness surfaces in the mesh; a 1 cm
        # solid thickness lets rays and contacts hit them
        ann[..., 8] = np.maximum(ann[..., 8], 0.01)
        geom = FamilyGeom(cyls=z["cyls"], boxes=z["boxes"], annuli=ann)
    elif family == "balls":
        # ball (0.2 m collision sphere), ball_no_geom (no geometry, valid
        # 0), balloon (bounded by its 0.2 m z semi-axis)
        sphs = np.zeros((3, 1, 5), np.float32)
        sphs[0, 0] = (0, 0, 0, 0.2, 1)
        sphs[1, 0] = (0, 0, 0, 0.0, 0)
        sphs[2, 0] = (0, 0, 0, 0.2, 1)
        geom = FamilyGeom(sphs=sphs)
    elif family == "objects":
        t = _load("objects.npy")                   # [5, 8]: kind 0 = box
        is_box = t[:, 0] == 0
        boxes = np.zeros((len(t), 1, 7), np.float32)
        boxes[:, 0, :3] = t[:, 1:4]
        boxes[:, 0, 3:6] = t[:, 4:7]
        boxes[:, 0, 6] = is_box
        sphs = np.zeros((len(t), 1, 5), np.float32)
        sphs[:, 0, :3] = t[:, 1:4]
        sphs[:, 0, 3] = t[:, 4]
        sphs[:, 0, 4] = ~is_box
        geom = FamilyGeom(boxes=boxes, sphs=sphs)
    else:
        raise KeyError(f"unknown asset family: {family}")
    _FAMILY_CACHE[family] = geom
    return geom


def num_variants(family: str) -> int:
    for t in family_geometry(family):
        if t is not None:
            return t.shape[0]
    return 0


def _yaw_rot(yaw, v):
    """Rotate [.., 3] vectors by per-element yaw [..] about z."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([c * v[..., 0] - s * v[..., 1],
                        s * v[..., 0] + c * v[..., 1], v[..., 2]], dim=-1)


class PlacedGroup(NamedTuple):
    cylinders: Optional[sc.Cylinders] = None
    spheres: Optional[sc.Spheres] = None
    boxes: Optional[sc.Boxes] = None
    annuli: Optional[sc.Annuli] = None


def place_group(family: str, variant_idx: torch.Tensor, pos_xy: torch.Tensor,
                yaw: torch.Tensor) -> PlacedGroup:
    """World-frame primitives for per-slot (variant, x, y, yaw) placements.

    variant_idx [N, P] int, pos_xy [N, P, 2], yaw [N, P]: every
    per-variant primitive is composed with its slot's transform; the slot
    and primitive axes flatten to [N, P * K, ...]. Table rows: a cylinder
    is center(3), axis(3), radius at 6, half length at 7, valid at 8."""
    g = family_geometry(family)
    n, p = variant_idx.shape
    dev, dt = pos_xy.device, pos_xy.dtype
    variant_idx = variant_idx.long()
    world_xyz = torch.cat([pos_xy, torch.zeros(pos_xy.shape[:-1] + (1,),
                                               dtype=dt, device=dev)],
                          dim=-1)                              # [N, P, 3]

    def rows(table):
        return torch.as_tensor(table, device=dev)[variant_idx]

    def compose_center(local_c):
        return _yaw_rot(yaw[..., None], local_c) + world_xyz[:, :, None, :]

    def flat(x, trailing):
        return x.reshape((n, -1) + trailing)

    cylinders = spheres = boxes = annuli = None
    if g.cyls is not None:
        row = rows(g.cyls)                                   # [N, P, C, 9]
        center = compose_center(row[..., 0:3])
        axis = _yaw_rot(yaw[..., None], row[..., 3:6])
        cylinders = sc.Cylinders(
            center=flat(center, (3,)), axis=flat(axis, (3,)),
            half_len=flat(row[..., 7], ()), radius=flat(row[..., 6], ()),
            valid=flat(row[..., 8] > 0, ()))
    if g.sphs is not None:
        row = rows(g.sphs)                                   # [N, P, S, 5]
        center = compose_center(row[..., 0:3])
        spheres = sc.Spheres(center=flat(center, (3,)),
                             radius=flat(row[..., 3], ()),
                             valid=flat(row[..., 4] > 0, ()))
    if g.boxes is not None:
        row = rows(g.boxes)                                  # [N, P, B, 7]
        center = compose_center(row[..., 0:3])
        nb = row.shape[2]
        boxes = sc.Boxes(
            center=flat(center, (3,)),
            yaw=flat(yaw[..., None].expand(n, p, nb), ()),
            half_extents=flat(row[..., 3:6], (3,)),
            valid=flat(row[..., 6] > 0, ()))
    if g.annuli is not None:
        row = rows(g.annuli)                                 # [N, P, A, 10]
        center = compose_center(row[..., 0:3])
        normal = _yaw_rot(yaw[..., None], row[..., 3:6])
        annuli = sc.Annuli(
            center=flat(center, (3,)), normal=flat(normal, (3,)),
            r_in=flat(row[..., 6], ()), r_out=flat(row[..., 7], ()),
            half_thick=flat(row[..., 8], ()),
            valid=flat(row[..., 9] > 0, ()))
    return PlacedGroup(cylinders=cylinders, spheres=spheres, boxes=boxes,
                       annuli=annuli)


def sample_tree_scene(generator: torch.Generator, n_envs: int,
                      num_trees: int, x_half: float, y_half: float,
                      device=None) -> sc.Cylinders:
    """A random thin-tree forest like the Planning / Customized reset:
    variants ~ U{0..99}, positions ~ U(-x_half, x_half) x U(-y_half,
    y_half), yaws ~ U(-pi, pi), drawn from ``generator`` in that order."""
    variant = torch.randint(0, 100, (n_envs, num_trees), generator=generator,
                            device=device)
    u = lambda *shape: torch.rand(shape, generator=generator, device=device)
    scale = torch.tensor([x_half, y_half], device=device)
    pos = (u(n_envs, num_trees, 2) * 2.0 - 1.0) * scale
    yaw = u(n_envs, num_trees) * (2.0 * math.pi) - math.pi
    return tree_cylinders_from_placement(variant, pos, yaw)
