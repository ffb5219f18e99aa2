"""Analytic scene primitives: collision queries and ray casts
(counterpart of airgym_tpu/physics/scene.py).

Tilted finite cylinders (tree trunks), spheres (goal balls, balloons),
yaw-rotated boxes (cubes), solid flat rings (flag gates) and the ground
plane. Every function is batched over a leading primitive axis P and
broadcasts over ray / query axes; invalid primitives report ``BIG``.

The depth renderer (render/depth.py) folds ``ray_*`` over the scene's
primitives; the fused render kernel (csrc/raycast.cuh) repeats the same
arithmetic per record.
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


class Boxes(NamedTuple):
    """Yaw-rotated boxes: center [.., P, 3], yaw [.., P], half_extents
    [.., P, 3], valid [.., P]."""
    center: torch.Tensor
    yaw: torch.Tensor
    half_extents: torch.Tensor
    valid: torch.Tensor


class Annuli(NamedTuple):
    """Solid flat rings (a board with a circular hole):
    {p : |(p-c)·n| <= half_thick, r_in <= |(p-c) - ((p-c)·n)n| <= r_out}.
    center [.., P, 3], unit normal [.., P, 3], r_in / r_out / half_thick
    [.., P], valid [.., P]."""
    center: torch.Tensor
    normal: torch.Tensor
    r_in: torch.Tensor
    r_out: torch.Tensor
    half_thick: torch.Tensor
    valid: torch.Tensor


def _big(x: torch.Tensor) -> torch.Tensor:
    return torch.full((), BIG, dtype=x.dtype, device=x.device)


# --------------------------------------------------------------------------
# distance queries (contact checks): point -> surface distance


def dist_to_cylinders(p: torch.Tensor, cyl: Cylinders) -> torch.Tensor:
    """Distance from point(s) p [.., 3] to each cylinder surface [.., P]
    (negative inside)."""
    d = p[..., None, :] - cyl.center
    along = torch.sum(d * cyl.axis, dim=-1)
    radial = d - along[..., None] * cyl.axis
    r = torch.linalg.norm(radial, dim=-1)
    dr = torch.clamp_min(r - cyl.radius, 0.0)
    dz = torch.clamp_min(torch.abs(along) - cyl.half_len, 0.0)
    outside = torch.sqrt(dr * dr + dz * dz)
    inside = torch.minimum(cyl.radius - r, cyl.half_len - torch.abs(along))
    dist = torch.where((dr > 0) | (dz > 0), outside, -inside)
    return torch.where(cyl.valid, dist, _big(dist))


def dist_to_spheres(p: torch.Tensor, sph: Spheres) -> torch.Tensor:
    d = torch.linalg.norm(p[..., None, :] - sph.center, dim=-1) - sph.radius
    return torch.where(sph.valid, d, _big(d))


def dist_to_boxes(p: torch.Tensor, box: Boxes) -> torch.Tensor:
    d = p[..., None, :] - box.center
    c, s = torch.cos(box.yaw), torch.sin(box.yaw)
    lx = c * d[..., 0] + s * d[..., 1]
    ly = -s * d[..., 0] + c * d[..., 1]
    local = torch.stack([lx, ly, d[..., 2]], dim=-1)
    q = torch.abs(local) - box.half_extents
    outside = torch.linalg.norm(torch.clamp_min(q, 0.0), dim=-1)
    inside = torch.clamp_max(torch.amax(q, dim=-1), 0.0)
    dist = outside + inside
    return torch.where(box.valid, dist, _big(dist))


def dist_to_annuli(p: torch.Tensor, ann: Annuli) -> torch.Tensor:
    """Signed distance from point(s) p [.., 3] to each solid ring [.., P]."""
    d = p[..., None, :] - ann.center
    h = torch.sum(d * ann.normal, dim=-1)
    radial = d - h[..., None] * ann.normal
    rho = torch.linalg.norm(radial, dim=-1)
    drho = torch.clamp_min(torch.maximum(ann.r_in - rho, rho - ann.r_out),
                           0.0)
    dh = torch.clamp_min(torch.abs(h) - ann.half_thick, 0.0)
    outside = torch.sqrt(drho * drho + dh * dh)
    inside = torch.minimum(torch.minimum(rho - ann.r_in, ann.r_out - rho),
                           ann.half_thick - torch.abs(h))
    dist = torch.where((drho > 0) | (dh > 0), outside, -inside)
    return torch.where(ann.valid, dist, _big(dist))


# --------------------------------------------------------------------------
# ray casts (depth camera): origin o, unit dir v -> hit distance t (BIG
# when no hit). Shapes: o, v [.., R, 3]; primitives [.., P, ...]; result
# [.., R] = min over P.


def _safe(x: torch.Tensor, eps: float) -> torch.Tensor:
    """x with |x| < eps replaced by +eps."""
    return torch.where(torch.abs(x) < eps, torch.full_like(x, eps), x)


def ray_ground(o: torch.Tensor, v: torch.Tensor, z: float = 0.0):
    t = (z - o[..., 2]) / _safe(v[..., 2], 1e-9)
    return torch.where(t > 1e-6, t, _big(t))


def ray_spheres(o, v, sph: Spheres) -> torch.Tensor:
    oc = o[..., None, :] - sph.center[..., None, :, :]      # [.., R, P, 3]
    b = torch.sum(oc * v[..., None, :], dim=-1)             # [.., R, P]
    c = torch.sum(oc * oc, dim=-1) - torch.square(sph.radius)[..., None, :]
    disc = b * b - c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t = -b - sq
    hit = (disc > 0) & (t > 1e-6) & sph.valid[..., None, :]
    return torch.amin(torch.where(hit, t, _big(t)), dim=-1)


def ray_cylinders(o, v, cyl: Cylinders) -> torch.Tensor:
    """Finite (uncapped) cylinder intersection: tree trunks end in the
    ground or above the camera frustum."""
    ax = cyl.axis[..., None, :, :]                          # [.., 1, P, 3]
    ce = cyl.center[..., None, :, :]
    oc = o[..., None, :] - ce                               # [.., R, P, 3]
    vv = v[..., None, :]                                    # [.., R, 1, 3]

    v_par = torch.sum(vv * ax, dim=-1)                      # [.., R, P]
    o_par = torch.sum(oc * ax, dim=-1)
    v_perp = vv - v_par[..., None] * ax
    o_perp = oc - o_par[..., None] * ax

    a = torch.sum(v_perp * v_perp, dim=-1)
    b = torch.sum(o_perp * v_perp, dim=-1)
    c = torch.sum(o_perp * o_perp, dim=-1) - torch.square(
        cyl.radius)[..., None, :]
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    a_safe = torch.where(a < 1e-9, torch.full_like(a, 1e-9), a)
    t = (-b - sq) / a_safe
    h = o_par + t * v_par
    hit = ((disc > 0) & (t > 1e-6)
           & (torch.abs(h) <= cyl.half_len[..., None, :])
           & cyl.valid[..., None, :])
    return torch.amin(torch.where(hit, t, _big(t)), dim=-1)


def ray_annuli(o, v, ann: Annuli) -> torch.Tensor:
    """Ray vs solid flat ring: the thickness slab intersected with the
    radial band [r_in, r_out]; a ray entering inside the hole exits
    through the inner rim."""
    nrm = ann.normal[..., None, :, :]                       # [.., 1, P, 3]
    ce = ann.center[..., None, :, :]
    oc = o[..., None, :] - ce                               # [.., R, P, 3]
    vv = v[..., None, :]
    big = _big(oc)

    vh = torch.sum(vv * nrm, dim=-1)                        # [.., R, P]
    oh = torch.sum(oc * nrm, dim=-1)
    ht = ann.half_thick[..., None, :]
    vh_safe = _safe(vh, 1e-9)
    tsa = (-ht - oh) / vh_safe
    tsb = (ht - oh) / vh_safe
    ts1 = torch.minimum(tsa, tsb)
    ts2 = torch.maximum(tsa, tsb)
    flat = torch.abs(vh) < 1e-9                 # ray parallel to the disc
    in_slab = torch.abs(oh) <= ht
    ts1 = torch.where(flat, torch.where(in_slab, -big, big), ts1)
    ts2 = torch.where(flat, torch.where(in_slab, big, -big), ts2)

    v_perp = vv - vh[..., None] * nrm
    o_perp = oc - oh[..., None] * nrm
    a = torch.sum(v_perp * v_perp, dim=-1)
    b = torch.sum(o_perp * v_perp, dim=-1)
    osq = torch.sum(o_perp * o_perp, dim=-1)
    r_in = ann.r_in[..., None, :]
    r_out = ann.r_out[..., None, :]
    a_safe = torch.clamp_min(a, 1e-12)
    par = a < 1e-12                             # ray along the normal

    c_o = osq - r_out * r_out
    disc_o = b * b - a * c_o
    sq_o = torch.sqrt(torch.clamp_min(disc_o, 0.0))
    to1 = (-b - sq_o) / a_safe
    to2 = (-b + sq_o) / a_safe
    c_i = osq - r_in * r_in
    in_band = (c_o <= 0) & (c_i > 0)
    to1 = torch.where(par, torch.where(in_band, -big, big),
                      torch.where(disc_o > 0, to1, big))
    to2 = torch.where(par, torch.where(in_band, big, -big),
                      torch.where(disc_o > 0, to2, -big))

    disc_i = b * b - a * c_i
    sq_i = torch.sqrt(torch.clamp_min(disc_i, 0.0))
    ti1 = (-b - sq_i) / a_safe
    ti2 = (-b + sq_i) / a_safe
    has_inner = (disc_i > 0) & ~par & (r_in > 0)

    lo = torch.maximum(ts1, to1)
    hi = torch.minimum(ts2, to2)
    in_hole = has_inner & (lo > ti1) & (lo < ti2)
    lo = torch.where(in_hole, ti2, lo)
    hit = (lo <= hi) & (lo > 1e-6) & ann.valid[..., None, :]
    return torch.amin(torch.where(hit, lo, big), dim=-1)


def ray_boxes(o, v, box: Boxes) -> torch.Tensor:
    """Slab-test intersection with yaw-rotated boxes."""
    c, s = torch.cos(box.yaw), torch.sin(box.yaw)           # [.., P]
    d = o[..., None, :] - box.center[..., None, :, :]       # [.., R, P, 3]
    c_, s_ = c[..., None, :], s[..., None, :]

    def to_local(w):
        wx = c_ * w[..., 0] + s_ * w[..., 1]
        wy = -s_ * w[..., 0] + c_ * w[..., 1]
        return torch.stack([wx, wy, w[..., 2]], dim=-1)

    lo = to_local(d)
    lv = _safe(to_local(torch.broadcast_to(v[..., None, :], d.shape)), 1e-9)
    he = box.half_extents[..., None, :, :]
    t1 = (-he - lo) / lv
    t2 = (he - lo) / lv
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    hit = (tmax >= tmin) & (tmax > 1e-6) & box.valid[..., None, :]
    t = torch.where(tmin > 1e-6, tmin, tmax)
    return torch.amin(torch.where(hit, t, _big(t)), dim=-1)
