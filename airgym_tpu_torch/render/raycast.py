"""Fused depth render + post-processing (counterpart of
airgym_tpu/render/pallas_raycast.py).

``render_process`` renders every env's camera image and post-processes it
in one kernel on the card (``csrc/render_process.cu`` on
``csrc/raycast.cuh``): the raw depth never reaches device memory. For CPU
tensors it runs ``render_process_plain``, which repeats the kernel's
arithmetic in the same order; the tests hold it against the Pallas kernel
(interpret mode) and against ``postprocess_hash(render_depth(...))``, and
``chip_smoke.py`` holds the CUDA kernel against it.

Around the kernel, in plain PyTorch as the JAX package has them in XLA:
``pack_scene`` (the [N, P, 12] record table, layout in raycast.cuh),
``cull_and_compact`` (the per-env visibility prepass), the per-env seeds
``_env_seeds`` and the hashed blur taps ``_hash_kernel_taps``. The hash
arithmetic is ``ops/hash_rng.py``'s, so its bits equal the TPU's and the
card's.

Rule shared with the TPU kernel: culling (``cull_far_z``) applies only to
tables of more than 16 records; below that the prepass and the guards
cost more than the records they skip.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from airgym_tpu_torch.kernels import build
from airgym_tpu_torch.math import rotations as rot
from airgym_tpu_torch.ops import hash_rng as hr
from airgym_tpu_torch.physics import scene as sc
from airgym_tpu_torch.render import depth as dr

BIG = sc.BIG
LANES = 128      # the TPU image block's lanes: the hash's pixel index
GROUP = 8        # records per guard
CULL_MIN_RECORDS = 16

_TAP_SALT = 0xA511E9B3
_TAP_STEP = 0x63D83595
_SEED_STEP = 0x01000193

KERNEL = build.CudaKernel(
    "render_process",
    {"render_process_launch": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
     + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p],
     "render_process_smem_bytes": [ctypes.c_int] * 3},
    extra_flags=["-fmad=false"])


def pack_scene(n: int, scene: dr.SceneForRender, device=None):
    """SceneForRender -> (packed [N, P_pad, 12] record table, static
    per-kind counts (cylinders, spheres, boxes, annuli)). P is padded to a
    multiple of 8 with invalid records."""
    recs = []

    def table(p, kind, valid, center):
        r = torch.zeros((n, p, 12), dtype=torch.float32, device=device)
        r[..., 0] = torch.where(valid, float(kind), 0.0)
        r[..., 1:4] = center
        return r

    counts = [0, 0, 0, 0]
    if scene.cylinders is not None:
        c = scene.cylinders
        r = table(c.radius.shape[1], 1, c.valid, c.center)
        r[..., 4:7] = c.axis
        r[..., 7] = c.half_len
        r[..., 8] = c.radius
        recs.append(r)
        counts[0] = r.shape[1]
    if scene.spheres is not None:
        s = scene.spheres
        r = table(s.radius.shape[1], 2, s.valid, s.center)
        r[..., 8] = s.radius
        recs.append(r)
        counts[1] = r.shape[1]
    if scene.boxes is not None:
        b = scene.boxes
        r = table(b.yaw.shape[1], 3, b.valid, b.center)
        r[..., 4] = torch.cos(b.yaw)
        r[..., 5] = torch.sin(b.yaw)
        r[..., 9:12] = b.half_extents
        recs.append(r)
        counts[2] = r.shape[1]
    if scene.annuli is not None:
        a = scene.annuli
        r = table(a.r_in.shape[1], 4, a.valid, a.center)
        r[..., 4:7] = a.normal
        r[..., 7] = a.half_thick
        r[..., 8] = a.r_in
        r[..., 9] = a.r_out
        recs.append(r)
        counts[3] = r.shape[1]
    if not recs:
        recs.append(torch.zeros((n, 1, 12), dtype=torch.float32,
                                device=device))
    out = torch.cat(recs, dim=1)
    p = out.shape[1]
    p_pad = -(-p // 8) * 8
    if p_pad != p:
        out = torch.nn.functional.pad(out, (0, 0, 0, p_pad - p))
    return out, tuple(counts)


def _corner_tan(cfg: dr.CameraCfg) -> float:
    """tan of the half-angle of the cone that holds every ray."""
    tan_h = float(np.tan(np.radians(cfg.horizontal_fov_deg) / 2.0))
    tan_v = tan_h * cfg.height / cfg.width
    return float(np.hypot(tan_h, tan_v))


def cull_and_compact(table: torch.Tensor, counts: tuple,
                     origin: torch.Tensor, forward: torch.Tensor,
                     far_z: float, corner_tan: float):
    """Per-env visibility cull + in-segment compaction -> (table, live
    counts [N, 4] int32).

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

    n_cyl, n_sph, n_box, n_ann = counts
    rbs = []
    p0 = 0
    if n_cyl:
        seg = table[:, :n_cyl]
        rbs.append(torch.sqrt(seg[..., 7] ** 2 + seg[..., 8] ** 2))
    p0 += n_cyl
    if n_sph:
        rbs.append(table[:, p0:p0 + n_sph, 8])
    p0 += n_sph
    if n_box:
        rbs.append(torch.linalg.norm(table[:, p0:p0 + n_box, 9:12], dim=-1))
    p0 += n_box
    if n_ann:
        seg = table[:, p0:p0 + n_ann]
        rbs.append(torch.sqrt(seg[..., 9] ** 2 + seg[..., 7] ** 2))
    p0 += n_ann
    if table.shape[1] > p0:
        rbs.append(torch.zeros((n, table.shape[1] - p0), dtype=table.dtype,
                               device=table.device))
    rb = torch.cat(rbs, dim=1)

    vis = ((dq * cos_t - dp * sin_t <= rb) & (dp - rb <= far_z)
           & (table[..., 0] > 0.0))

    segments, live = [], []
    p0 = 0
    for cnt in counts:
        if cnt == 0:
            live.append(torch.zeros((n,), dtype=torch.int32,
                                    device=table.device))
            continue
        v = vis[:, p0:p0 + cnt]
        order = torch.argsort((~v).to(torch.int8), dim=1, stable=True)
        segments.append(torch.take_along_dim(
            table[:, p0:p0 + cnt], order[..., None], dim=1))
        live.append(torch.sum(v, dim=1).to(torch.int32))
        p0 += cnt
    if table.shape[1] > p0:
        segments.append(table[:, p0:])
    return torch.cat(segments, dim=1), torch.stack(live, dim=1)


def _env_seeds(seed, n: int, device=None) -> torch.Tensor:
    """Per-env hash keys [N] (uint32 values in int64): seed + i *
    0x01000193 over the whole batch."""
    if isinstance(seed, torch.Tensor):
        seed = seed.to(device=device, dtype=torch.int64).reshape(()) & hr.M32
    else:
        seed = int(seed) & hr.M32
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
    TPU kernel's (rows, 128) image block."""
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


def postprocess_hash(cfg: dr.CameraCfg, depth: torch.Tensor,
                     seed) -> torch.Tensor:
    """The fused kernel's post-processing alone: raw z-depth [N, W, H]
    (render/depth.render_depth) -> [N, 1, W, H], same hash RNG and draw
    order as the kernel."""
    n = depth.shape[0]
    seeds = _env_seeds(seed, n, depth.device)
    return _postprocess(depth, seeds, _hash_kernel_taps(seeds),
                        float(cfg.depth_clamp))[:, None]


# ---------------------------------------------------------------------------
# kernel inputs, the kernel wrapper and its plain version


class RenderInputs(NamedTuple):
    """Everything the kernel reads, as the wrapper hands it over."""
    cfg: dr.CameraCfg
    origins: torch.Tensor       # [N, 8] f32: camera origin, padded
    rots: torch.Tensor          # [N, 16] f32: body matrix row-major, padded
    prims: torch.Tensor         # [N, P, 12] f32 packed records
    live: torch.Tensor          # [N, 4] int32 live records per kind
    seeds: torch.Tensor         # [N] int64 holding the uint32 env keys
    taps: torch.Tensor          # [N, 1, 32] f32
    counts: tuple               # static records per kind
    ground: bool


def _tans(cfg: dr.CameraCfg):
    tan_h = float(np.tan(np.radians(cfg.horizontal_fov_deg) / 2.0))
    return tan_h, tan_h * cfg.height / cfg.width


def prepare(cfg: dr.CameraCfg, root_states: torch.Tensor,
            scene: dr.SceneForRender, seed,
            cull_far_z: Optional[float] = None) -> RenderInputs:
    """Camera pose, packed (and optionally culled) scene, env seeds and
    taps from the drones' root states [N, 13]."""
    if cfg.height > LANES - 2:
        raise ValueError(f"fused render+process requires H <= {LANES - 2}")
    n, dev = root_states.shape[0], root_states.device
    q = root_states[:, 3:7]
    m = rot.quat_to_matrix(q).reshape(n, 9).to(torch.float32)
    mount = torch.tensor(cfg.mount_pos, dtype=root_states.dtype,
                         device=dev).expand(n, 3)
    origin = (root_states[:, 0:3] + rot.quat_rotate(q, mount)).to(
        torch.float32)
    prims, counts = pack_scene(n, scene, dev)
    if cull_far_z is not None and prims.shape[1] <= CULL_MIN_RECORDS:
        cull_far_z = None
    if cull_far_z is not None:
        prims, live = cull_and_compact(prims, counts, origin,
                                       m[:, [0, 3, 6]], float(cull_far_z),
                                       _corner_tan(cfg))
    else:
        live = torch.tensor(counts, dtype=torch.int32,
                            device=dev)[None].repeat(n, 1)
    seeds = _env_seeds(seed, n, dev)
    pad = torch.nn.functional.pad
    return RenderInputs(cfg=cfg, origins=pad(origin, (0, 5)),
                        rots=pad(m, (0, 7)), prims=prims.contiguous(),
                        live=live.contiguous(), seeds=seeds,
                        taps=_hash_kernel_taps(seeds), counts=counts,
                        ground=bool(scene.ground))


def _check(inp: RenderInputs) -> None:
    n = inp.origins.shape[0]
    dev = inp.origins.device
    p = inp.prims.shape[1] if inp.prims.dim() == 3 else -1
    want = {"origins": (inp.origins, (n, 8), torch.float32),
            "rots": (inp.rots, (n, 16), torch.float32),
            "prims": (inp.prims, (n, p, 12), torch.float32),
            "live": (inp.live, (n, 4), torch.int32),
            "seeds": (inp.seeds, (n,), torch.int64),
            "taps": (inp.taps, (n, 1, 32), torch.float32)}
    for name, (x, shape, dtype) in want.items():
        if tuple(x.shape) != shape or x.dtype != dtype or x.device != dev:
            raise ValueError(f"{name}: want {dtype} {shape} on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if sum(inp.counts) > p or len(inp.counts) != 4:
        raise ValueError(f"counts {inp.counts} exceed the {p} records")


def render_process_packed(inp: RenderInputs) -> torch.Tensor:
    """Kernel inputs -> post-processed images [N, 1, W, H]: launches the
    CUDA kernel for CUDA tensors (or raises), runs the plain version for
    CPU tensors."""
    _check(inp)
    if not inp.origins.is_cuda:
        return render_process_packed_plain(inp)
    cfg = inp.cfg
    n, p = inp.prims.shape[0], inp.prims.shape[1]
    W, H = cfg.width, cfg.height
    lib = KERNEL.lib()
    if lib.render_process_smem_bytes(p, W, H) == 0:
        raise ValueError(f"a {W} x {H} image with {p} records exceeds one "
                         f"block's shared memory")
    out = torch.empty((n, 1, W, H), dtype=torch.float32,
                      device=inp.origins.device)
    # the uint32 keys as int32 bits
    seeds = torch.where(inp.seeds >= 2 ** 31, inp.seeds - 2 ** 32,
                        inp.seeds).to(torch.int32)
    tan_h, tan_v = _tans(cfg)
    args = [x.contiguous() for x in (inp.origins, inp.rots, inp.prims,
                                      inp.live, seeds, inp.taps)]
    KERNEL.call("render_process_launch", *[x.data_ptr() for x in args],
                out.data_ptr(), n, p, *inp.counts, W, H, tan_h, tan_v,
                int(inp.ground), float(cfg.depth_clamp),
                torch.cuda.current_stream(out.device).cuda_stream)
    KERNEL.launches["render_process"] += 1
    return out


# ---- plain version: the kernel's arithmetic in the kernel's order ---------


def _cast_record(kind: int, rec: torch.Tensor, ray, t_eu: torch.Tensor):
    """One record [n, 12] against the rays: csrc/raycast.cuh
    cast_record."""
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
    elif kind == 3:
        cyaw, syaw = f(4), f(5)
        lox = cyaw * ocx + syaw * ocy
        loy = -syaw * ocx + cyaw * ocy
        lvx = cyaw * ux + syaw * uy
        lvy = -syaw * ux + cyaw * uy
        tmin = tmax = None
        for o_, d_, he in ((lox, lvx, f(9)), (loy, lvy, f(10)),
                           (ocz, uz, f(11))):
            d_ = where(torch.abs(d_) < 1e-9, 1e-9, d_)
            t1 = (-he - o_) / d_
            t2 = (he - o_) / d_
            lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
            tmin = lo if tmin is None else torch.maximum(tmin, lo)
            tmax = hi if tmax is None else torch.minimum(tmax, hi)
        t_p = where(tmin > 1e-6, tmin, tmax)
        hit = (tmax >= tmin) & (tmax > 1e-6)
    else:
        nx, ny, nz, ht, ri, ro = f(4), f(5), f(6), f(7), f(8), f(9)
        vh = ux * nx + uy * ny + uz * nz
        oh = ocx * nx + ocy * ny + ocz * nz
        vh_safe = where(torch.abs(vh) < 1e-9, 1e-9, vh)
        tsa = (-ht - oh) / vh_safe
        tsb = (ht - oh) / vh_safe
        ts1, ts2 = torch.minimum(tsa, tsb), torch.maximum(tsa, tsb)
        flat = torch.abs(vh) < 1e-9
        in_slab = torch.abs(oh) <= ht
        ts1 = where(flat, where(in_slab, -big, big), ts1)
        ts2 = where(flat, where(in_slab, big, -big), ts2)
        vpx, vpy, vpz = ux - vh * nx, uy - vh * ny, uz - vh * nz
        opx, opy, opz = ocx - oh * nx, ocy - oh * ny, ocz - oh * nz
        a = vpx * vpx + vpy * vpy + vpz * vpz
        b = opx * vpx + opy * vpy + opz * vpz
        osq = opx * opx + opy * opy + opz * opz
        a_safe = torch.clamp_min(a, 1e-12)
        par = a < 1e-12
        c_o = osq - ro * ro
        disc_o = b * b - a * c_o
        sq_o = torch.sqrt(torch.clamp_min(disc_o, 0.0))
        to1 = (-b - sq_o) / a_safe
        to2 = (-b + sq_o) / a_safe
        c_i = osq - ri * ri
        in_band = (c_o <= 0) & (c_i > 0)
        to1 = where(par, where(in_band, -big, big), where(disc_o > 0, to1, big))
        to2 = where(par, where(in_band, big, -big),
                    where(disc_o > 0, to2, -big))
        disc_i = b * b - a * c_i
        sq_i = torch.sqrt(torch.clamp_min(disc_i, 0.0))
        ti1 = (-b - sq_i) / a_safe
        ti2 = (-b + sq_i) / a_safe
        has_inner = (disc_i > 0) & ~par & (ri > 0)
        lo = torch.maximum(ts1, to1)
        hi = torch.minimum(ts2, to2)
        lo = where(has_inner & (lo > ti1) & (lo < ti2), ti2, lo)
        t_p = lo
        hit = (lo <= hi) & (lo > 1e-6)
    return torch.minimum(t_eu, where(hit & (valid > 0.0), t_p, big))


def _render_chunk(inp: RenderInputs, sl: slice) -> torch.Tensor:
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
    depth = (t * inv).reshape(-1, W, H)
    return _postprocess(depth, inp.seeds[sl], inp.taps[sl],
                        float(cfg.depth_clamp))


def render_process_packed_plain(inp: RenderInputs,
                                chunk: int = 512) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/render_process.cu`` (chunks of
    ``chunk`` envs bound its memory; the envs are independent)."""
    n = inp.origins.shape[0]
    outs = [_render_chunk(inp, slice(i, min(i + chunk, n)))
            for i in range(0, n, chunk)]
    return torch.cat(outs, dim=0)[:, None]


def render_process(cfg: dr.CameraCfg, root_states: torch.Tensor,
                   scene: dr.SceneForRender, seed,
                   cull_far_z: Optional[float] = None) -> torch.Tensor:
    """Fused drop-in for ``postprocess_hash(cfg, render_depth(...), seed)``
    -> [N, 1, W, H]: the CUDA kernel for CUDA tensors, its plain version
    for CPU tensors."""
    return render_process_packed(prepare(cfg, root_states, scene, seed,
                                         cull_far_z))


def render_process_plain(cfg: dr.CameraCfg, root_states: torch.Tensor,
                         scene: dr.SceneForRender, seed,
                         cull_far_z: Optional[float] = None) -> torch.Tensor:
    """``render_process`` through the plain version on any device."""
    return render_process_packed_plain(prepare(cfg, root_states, scene,
                                               seed, cull_far_z))
