"""The plain version of the fused render + process kernel
(csrc/render_process.cu on csrc/raycast.cuh): every env's camera image
rendered and post-processed, the kernel's arithmetic in the kernel's order
through one caster (``_cast_record``, ``_cast_chunk``).

Around the kernel, as the program has them: ``pack_scene`` (the [N, P,
12] record table, layout in raycast.cuh), ``cull_and_compact`` (the
per-env visibility prepass; the program culls tables of more than 16
records, as Planning's are), the per-env seeds ``_env_seeds`` and the
hashed blur taps ``_hash_kernel_taps``. The hash arithmetic is
``ops/hash_rng.py``'s.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.plain.math import rotations as rot
from portbench.reference.plain.ops import hash_rng as hr
from portbench.reference.plain.physics import scene as sc
from portbench.reference.plain.render import depth as dr

BIG = sc.BIG
LANES = 128      # the TPU image block's lanes: the hash's pixel index
GROUP = 8        # records per guard
CULL_MIN_RECORDS = 16

_TAP_SALT = 0xA511E9B3
_TAP_STEP = 0x63D83595
_SEED_STEP = 0x01000193


def pack_scene(n: int, scene: dr.SceneForRender, device=None):
    """SceneForRender -> (packed [N, P_pad, 12] record table, static
    per-kind counts (cylinders, spheres)). P is padded to a multiple of 8
    with invalid records."""

    def table(p, kind, valid, center):
        r = torch.zeros((n, p, 12), dtype=torch.float32, device=device)
        r[..., 0] = torch.where(valid, float(kind), 0.0)
        r[..., 1:4] = center
        return r

    c = scene.cylinders
    cyl = table(c.radius.shape[1], 1, c.valid, c.center)
    cyl[..., 4:7] = c.axis
    cyl[..., 7] = c.half_len
    cyl[..., 8] = c.radius
    s = scene.spheres
    sph = table(s.radius.shape[1], 2, s.valid, s.center)
    sph[..., 8] = s.radius
    out = torch.cat([cyl, sph], dim=1)
    p = out.shape[1]
    p_pad = -(-p // 8) * 8
    if p_pad != p:
        out = torch.nn.functional.pad(out, (0, 0, 0, p_pad - p))
    return out, (cyl.shape[1], sph.shape[1])


def _corner_tan(cfg: dr.CameraCfg) -> float:
    """tan of the half-angle of the cone that holds every ray."""
    tan_h = float(np.tan(np.radians(cfg.horizontal_fov_deg) / 2.0))
    tan_v = tan_h * cfg.height / cfg.width
    return float(np.hypot(tan_h, tan_v))


def cull_and_compact(table: torch.Tensor, counts: tuple,
                     origin: torch.Tensor, forward: torch.Tensor,
                     far_z: float, corner_tan: float):
    """Per-env visibility cull + in-segment compaction -> (table, live
    counts [N, 2] int32).

    A record cannot change the image clipped at ``far_z`` when its
    bounding sphere lies outside the cone that holds every camera ray, or
    when all of it projects beyond ``far_z`` along the camera axis.
    Survivors move to the front of their kind segment (stable order), so
    the kernel can skip whole groups past the live count; a culled record
    left in a live group is harmless, its contribution is clipped away."""
    n = table.shape[0]
    cos_t = 1.0 / float(np.sqrt(1.0 + corner_tan * corner_tan))
    sin_t = corner_tan * cos_t

    d = table[..., 1:4] - origin[:, None, :]
    dp = torch.einsum("npk,nk->np", d, forward)
    dq = torch.sqrt(torch.clamp_min(torch.sum(d * d, dim=-1) - dp * dp,
                                    0.0))

    n_cyl, n_sph = counts
    seg = table[:, :n_cyl]
    rbs = [torch.sqrt(seg[..., 7] ** 2 + seg[..., 8] ** 2),
           table[:, n_cyl:n_cyl + n_sph, 8]]
    p0 = n_cyl + n_sph
    if table.shape[1] > p0:
        rbs.append(torch.zeros((n, table.shape[1] - p0), dtype=table.dtype,
                               device=table.device))
    rb = torch.cat(rbs, dim=1)

    vis = ((dq * cos_t - dp * sin_t <= rb) & (dp - rb <= far_z)
           & (table[..., 0] > 0.0))

    segments, live = [], []
    p0 = 0
    for cnt in counts:
        v = vis[:, p0:p0 + cnt]
        order = torch.argsort((~v).to(torch.int8), dim=1, stable=True)
        segments.append(torch.take_along_dim(
            table[:, p0:p0 + cnt], order[..., None], dim=1))
        live.append(torch.sum(v, dim=1).to(torch.int32))
        p0 += cnt
    if table.shape[1] > p0:
        segments.append(table[:, p0:])
    return torch.cat(segments, dim=1), torch.stack(live, dim=1)


def _env_seeds(seed: torch.Tensor, n: int, device=None) -> torch.Tensor:
    """Per-env hash keys [N] (uint32 values in int64): seed (a 0-d
    integer tensor) + i * 0x01000193 over the whole batch."""
    seed = seed.to(device=device, dtype=torch.int64).reshape(()) & hr.M32
    i = torch.arange(n, dtype=torch.int64, device=device)
    return (seed + hr.mulmod(i, _SEED_STEP)) & hr.M32


def _hash_kernel_taps(env_seeds: torch.Tensor) -> torch.Tensor:
    """25 blur taps per env in {0..255}/256 (the hash twin of the
    reference's randint(0, 256)/256 kernel), padded to [N, 1, 32]."""
    j = torch.arange(25, dtype=torch.int64, device=env_seeds.device)
    salts = (_TAP_SALT + hr.mulmod(j, _TAP_STEP)) & hr.M32
    bits = hr.mix(hr.mulmod(env_seeds[:, None], 0x9E3779B9) ^ salts[None])
    k = (bits >> 24).to(torch.float32) / 256.0
    return torch.nn.functional.pad(k, (0, 7))[:, None, :]


def _pixel_lanes(w: int, h: int, device=None) -> torch.Tensor:
    """Hash index of each pixel [W * H]: u * 128 + v, its position in the
    TPU kernel's (rows, 128) image block (images of at most 126 rows)."""
    pix = torch.arange(w * h, dtype=torch.int64, device=device)
    return (pix // h) * LANES + pix % h


def _normal(draw):
    u1 = torch.clamp(draw(), 1e-7, 1.0)
    u2 = draw()
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d float32 tensor on ``like``'s device. Dividing by it is an
    IEEE division on the card too: PyTorch's CUDA division by a Python
    scalar multiplies by the reciprocal, which rounds otherwise than the
    kernel's division."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _postprocess(depth: torch.Tensor, seeds: torch.Tensor,
                 taps: torch.Tensor, clamp: float) -> torch.Tensor:
    """z-depth [n, W, H] -> post-processed [n, W, H], the kernel's steps
    2-4 on the unpadded image (the TPU block's padding is all zeros, and
    x >= 0, so its maxima and its rotate-based blur equal these)."""
    n, w, h = depth.shape
    x = torch.clamp(depth, 0.0, clamp) / _scalar(clamp, depth)
    mx = torch.amax(x, dim=(1, 2), keepdim=True)
    draw = hr.make_uniform(seeds[:, None],
                            _pixel_lanes(w, h, depth.device)[None])
    x = torch.minimum(torch.clamp_min(
        x + 0.1 * _normal(draw).reshape(n, w, h), 0.0), mx)
    mx = torch.amax(x, dim=(1, 2), keepdim=True)
    x = torch.minimum(torch.clamp_min(
        x * (1.0 + 0.3 * _normal(draw).reshape(n, w, h)), 0.0), mx)
    xp = torch.nn.functional.pad(x, (2, 2, 2, 2))
    blur = torch.zeros_like(x)
    for a in range(5):
        for b in range(5):
            blur = blur + taps[:, 0, a * 5 + b, None, None] * \
                xp[:, a:a + w, b:b + h]
    return blur


# ---------------------------------------------------------------------------
# kernel inputs and the plain version


class RenderInputs(NamedTuple):
    """Everything the kernel reads, as the program's wrapper hands it
    over."""
    cfg: dr.CameraCfg
    origins: torch.Tensor       # [N, 8] f32: camera origin, padded
    rots: torch.Tensor          # [N, 16] f32: body matrix row-major, padded
    prims: torch.Tensor         # [N, P, 12] f32 packed records
    live: torch.Tensor          # [N, 2] int32 live records per kind
    seeds: torch.Tensor         # [N] int64 holding the uint32 env keys
    taps: torch.Tensor          # [N, 1, 32] f32
    counts: tuple               # static records per kind
    ground: bool


def _tans(cfg: dr.CameraCfg):
    tan_h = float(np.tan(np.radians(cfg.horizontal_fov_deg) / 2.0))
    return tan_h, tan_h * cfg.height / cfg.width


def prepare(cfg: dr.CameraCfg, root_states: torch.Tensor,
            scene: dr.SceneForRender, seed, cull_far_z: float) -> RenderInputs:
    """Camera pose and packed, culled scene from the drones' root states
    [N, 13], the env seeds and blur taps."""
    n, dev = root_states.shape[0], root_states.device
    q = root_states[:, 3:7]
    m = rot.quat_to_matrix(q).reshape(n, 9).to(torch.float32)
    mount = torch.tensor(cfg.mount_pos, dtype=root_states.dtype,
                         device=dev).expand(n, 3)
    origin = (root_states[:, 0:3] + rot.quat_rotate(q, mount)).to(
        torch.float32)
    prims, counts = pack_scene(n, scene, dev)
    if prims.shape[1] <= CULL_MIN_RECORDS:
        raise ValueError("Planning's table of trees is culled: more than "
                         f"{CULL_MIN_RECORDS} records, got {prims.shape[1]}")
    prims, live = cull_and_compact(prims, counts, origin, m[:, [0, 3, 6]],
                                   float(cull_far_z), _corner_tan(cfg))
    seeds = _env_seeds(seed, n, dev)
    taps = _hash_kernel_taps(seeds)
    pad = torch.nn.functional.pad
    return RenderInputs(cfg=cfg, origins=pad(origin, (0, 5)),
                        rots=pad(m, (0, 7)), prims=prims.contiguous(),
                        live=live.contiguous(), seeds=seeds, taps=taps,
                        counts=counts, ground=bool(scene.ground))


def _cast_record(kind: int, rec: torch.Tensor, ray, t_eu: torch.Tensor):
    """One record [n, 12] against the rays: csrc/raycast.cuh
    cast_record, for a cylinder (kind 1) or a sphere (kind 2)."""
    ox, oy, oz, ux, uy, uz = ray
    f = lambda k: rec[:, k:k + 1]
    valid = f(0)
    ocx, ocy, ocz = ox - f(1), oy - f(2), oz - f(3)
    big = torch.full((), BIG, dtype=t_eu.dtype, device=t_eu.device)
    where = torch.where
    if kind == 1:
        ax, ay, az, hl, rad = f(4), f(5), f(6), f(7), f(8)
        v_par = ux * ax + uy * ay + uz * az
        o_par = ocx * ax + ocy * ay + ocz * az
        vpx, vpy, vpz = ux - v_par * ax, uy - v_par * ay, uz - v_par * az
        opx, opy, opz = ocx - o_par * ax, ocy - o_par * ay, ocz - o_par * az
        a = vpx * vpx + vpy * vpy + vpz * vpz
        b = opx * vpx + opy * vpy + opz * vpz
        c = opx * opx + opy * opy + opz * opz - rad * rad
        disc = b * b - a * c
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        t_p = (-b - sq) / where(a < 1e-9, 1e-9, a)
        h = o_par + t_p * v_par
        hit = (disc > 0) & (t_p > 1e-6) & (torch.abs(h) <= hl)
    elif kind == 2:
        rad = f(8)
        b_s = ocx * ux + ocy * uy + ocz * uz
        c_s = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
        disc_s = b_s * b_s - c_s
        t_p = -b_s - torch.sqrt(torch.clamp_min(disc_s, 0.0))
        hit = (disc_s > 0) & (t_p > 1e-6)
    return torch.minimum(t_eu, where(hit & (valid > 0.0), t_p, big))


def _cast_chunk(inp: RenderInputs, sl: slice) -> torch.Tensor:
    """z-depth [n, W, H] of the envs ``sl``: the ray set-up, the ground
    and the record chain, the loop both kernels share."""
    cfg = inp.cfg
    W, H = cfg.width, cfg.height
    dev = inp.origins.device
    tan_h, tan_v = _tans(cfg)
    pix = torch.arange(W * H, device=dev)
    uf = (pix // H).to(torch.float32)[None]
    vf = (pix % H).to(torch.float32)[None]
    y = tan_h * (1.0 - 2.0 * (uf + 0.5) / _scalar(W, uf))
    z = tan_v * (1.0 - 2.0 * (vf + 0.5) / _scalar(H, vf))
    m = [inp.rots[sl, k:k + 1] for k in range(9)]
    dx = m[0] + m[1] * y + m[2] * z
    dy = m[3] + m[4] * y + m[5] * z
    dz = m[6] + m[7] * y + m[8] * z
    nsq = dx * dx + dy * dy + dz * dz
    inv = 1.0 / torch.sqrt(nsq)
    inv = inv * (1.5 - 0.5 * nsq * inv * inv)
    ux, uy, uz = dx * inv, dy * inv, dz * inv
    o = [inp.origins[sl, k:k + 1] for k in range(3)]
    ray = (o[0], o[1], o[2], ux, uy, uz)

    t = torch.full_like(ux, BIG)
    if inp.ground:
        tg = (0.0 - o[2]) / torch.where(torch.abs(uz) < 1e-9, 1e-9, uz)
        t = torch.where(tg > 1e-6, torch.minimum(t, tg), t)
    prims, live = inp.prims[sl], inp.live[sl]
    p = 0
    for slot, seg_n in enumerate(inp.counts):
        for g0 in range(0, seg_n, GROUP):
            t_g = t
            for k in range(min(GROUP, seg_n - g0)):
                t_g = _cast_record(slot + 1, prims[:, p + g0 + k], ray, t_g)
            t = torch.where((g0 < live[:, slot])[:, None], t_g, t)
        p += seg_n
    return (t * inv).reshape(-1, W, H)


def _by_chunks(fn, n: int, chunk: int = 512) -> torch.Tensor:
    """``fn(envs)`` over slices of ``chunk`` of the ``n`` envs (the envs
    are independent; chunks bound the plain versions' memory)."""
    return torch.cat([fn(slice(i, min(i + chunk, n)))
                      for i in range(0, n, chunk)], dim=0)


def render_process(cfg: dr.CameraCfg, root_states: torch.Tensor,
                   scene: dr.SceneForRender, seed,
                   cull_far_z: float) -> torch.Tensor:
    """Post-processed images [N, 1, W, H]: the cast, then the
    post-processing, over chunks of 512 envs."""
    inp = prepare(cfg, root_states, scene, seed, cull_far_z)
    clamp = float(inp.cfg.depth_clamp)
    return _by_chunks(lambda sl: _postprocess(
        _cast_chunk(inp, sl), inp.seeds[sl], inp.taps[sl], clamp),
        inp.origins.shape[0])[:, None]
