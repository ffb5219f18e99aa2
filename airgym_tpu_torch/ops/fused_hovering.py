"""Env-only fused Hovering rollout (counterpart of
airgym_tpu/ops/fused_hovering.py), and the step pieces every fused
rollout shares.

``rollout_fused`` runs T env steps under one constant remapped rate
action: it launches ``csrc/fused_hovering.cu`` for CUDA tensors and runs
``rollout_fused_plain`` for CPU tensors. The plain version repeats the
kernel's arithmetic and draw order; the tests hold it against the Pallas
kernel, and ``chip_smoke.py`` holds the CUDA kernel against it.

Packed state record (field-major [40, N] float32):
  0:13  root state (IsaacGym layout)   13:16 rate integrator
  16:19 prev body rate                 19 progress   20 reset flag
  21:25 pre_actions (remapped)         25:29 rotor state (motor lag)
  29:35 task extras (balloon)          35:40 pad

The plain step pieces below (``Rows``, ``control_physics``,
``hover_reward``, ``reset_root``, ``apply_reset``) are those of
``csrc/quad_step.cuh``; ``ops/fused_rollout.py`` builds the policy
rollout's plain version from them. Their draws come from
``ops/hash_rng.py``, keyed per 1024-env tile (``rng_base``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from airgym_tpu_torch.control import px4
from airgym_tpu_torch.kernels import build
from airgym_tpu_torch.ops import hash_rng as hr
from airgym_tpu_torch.ops import transcendental as tm
from airgym_tpu_torch.physics import quadrotor as qd

TILE = 1024                    # envs per Pallas grid cell: the RNG's tile
_F = 40                        # fields in the packed record
NROWS = 29                     # rows the hovering step reads and writes

_P = qd.x152b_params()
_G = px4.CascadeGains()
_DT = 0.01
_HOVER_MAX_LEN = 2400          # 24 s / 0.01

KERNEL = build.CudaKernel("fused_hovering", {"fused_hovering_launch": [
    ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_float,
    ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_uint32, ctypes.c_float, ctypes.c_float,
    ctypes.c_int, ctypes.c_void_p]})


def pack_state(core) -> torch.Tensor:
    """envs.base.EnvState (hovering core) -> [40, N] record."""
    n = core.root.shape[0]
    s = torch.zeros((_F, n), dtype=torch.float32, device=core.root.device)
    s[0:13] = core.root.T
    s[13:16] = core.ctrl.rate_int.T
    s[16:19] = core.ctrl.prev_rate.T
    s[19] = core.progress.to(torch.float32)
    s[20] = core.reset_buf.to(torch.float32)
    s[21:25] = core.pre_actions.T
    if core.rotors is not None:
        s[25:29] = core.rotors.T
    return s


def unpack_root(s: torch.Tensor) -> torch.Tensor:
    return s[0:13].T


def rng_base(seed: int, n: int, device) -> tuple:
    """(tile seed [N], lane [N]): the tile and lane come from the env
    index, as in ``common.cuh: tile_seed``."""
    env = torch.arange(n, dtype=torch.int64, device=device)
    tile = env // TILE
    base = ((int(seed) & hr.M32) + hr.mulmod(tile, 0x01000193)) & hr.M32
    return base, env % TILE


def step_uniform(base, lanes, step_i: int):
    """The uniform stream of one step: key = base ^ (step+1) * golden."""
    return hr.make_uniform(base ^ hr.mulmod(step_i + 1, 0x9E3779B1), lanes)


def _quat_from_euler(ax, ay, az):
    """Intrinsic XYZ euler -> xyzw quat: q = qx(a) * qy(b) * qz(c)."""
    cx, sx = torch.cos(ax * 0.5), torch.sin(ax * 0.5)
    cy, sy = torch.cos(ay * 0.5), torch.sin(ay * 0.5)
    cz, sz = torch.cos(az * 0.5), torch.sin(az * 0.5)
    x1, y1, z1, w1 = sx * cy, cx * sy, sx * sy, cx * cy
    qx = x1 * cz + y1 * sz
    qy = y1 * cz - x1 * sz
    qz = w1 * sz + z1 * cz
    qw = w1 * cz - z1 * sz
    return qx, qy, qz, qw


# ---------------------------------------------------------------------------
# plain step pieces (csrc/quad_step.cuh)


class Rows:
    """The 29 state rows a step owns, as [N] tensors."""
    NAMES = ("px", "py", "pz", "qx", "qy", "qz", "qw", "vx", "vy", "vz",
             "wx", "wy", "wz", "rix", "riy", "riz", "prx", "pry", "prz",
             "prog", "rstf", "pa0", "pa1", "pa2", "pa3",
             "r1", "r2", "r3", "r4")

    def __init__(self, packed: torch.Tensor):
        for i, name in enumerate(self.NAMES):
            setattr(self, name, packed[i].clone())

    def stack(self) -> torch.Tensor:
        return torch.stack([getattr(self, k) for k in self.NAMES], dim=0)


def _pid(err, integ, wprev, wnow, kp, ki, kd):
    integ = torch.clamp(integ + err * _DT * ki, -_G.rate_int_lim,
                        _G.rate_int_lim)
    d = -(wnow - wprev) / _DT * kd
    return torch.clamp(kp * err + integ + d, -_G.torque_lim,
                       _G.torque_lim), integ


def control_physics(s: Rows, a0, a1, a2, thrust, motor_alpha: float,
                    env_only: bool = False):
    """PX4 rate PID + mixer + yaw desaturation, optional motor lag, the
    6-DoF physics with exp-map quaternion integration; updates ``s`` and
    returns the commanded thrusts (c1, c2, c3, c4), zero on the first
    step after a reset. ``env_only`` adds the mixer's roll / pitch
    columns before the thrust, as the env-only kernel does."""
    mass, g = _P.mass, _P.gravity
    ixx, iyy, izz = _P.inertia_diag
    ts_, tq = _P.thrust_scale, _P.torque_scale
    L = _P.rotor_pos[0][0]
    kp, ki, kd = _G.rate_p, _G.rate_i, _G.rate_d

    one = torch.ones_like(s.qw)
    flip = torch.where(s.qw < 0.0, -one, one)
    qx_, qy_, qz_, qw_ = s.qx * flip, s.qy * flip, s.qz * flip, s.qw * flip
    wx, wy, wz = s.wx, s.wy, s.wz
    a = 2.0 * qw_ * qw_ - 1.0
    d = -(qx_ * wx + qy_ * wy + qz_ * wz)
    wbx = a * wx + 2.0 * qw_ * (-qy_ * wz + qz_ * wy) - 2.0 * d * qx_
    wby = a * wy + 2.0 * qw_ * (-qz_ * wx + qx_ * wz) - 2.0 * d * qy_
    wbz = a * wz + 2.0 * qw_ * (-qx_ * wy + qy_ * wx) - 2.0 * d * qz_

    tx, s.rix = _pid(a0 - wbx, s.rix, s.prx, wbx, kp[0], ki[0], kd[0])
    ty, s.riy = _pid(a1 - wby, s.riy, s.pry, wby, kp[1], ki[1], kd[1])
    tz, s.riz = _pid(a2 - wbz, s.riz, s.prz, wbz, kp[2], ki[2], kd[2])
    s.prx, s.pry, s.prz = wbx, wby, wbz

    if env_only:
        f1, f2 = thrust + (-tx - ty), thrust + (tx + ty)
        f3, f4 = thrust + (tx - ty), thrust + (-tx + ty)
    else:
        f1, f2 = thrust - tx - ty, thrust + tx + ty
        f3, f4 = thrust + tx - ty, thrust - tx + ty
    mn = torch.minimum(torch.minimum(f1, f2), torch.minimum(f3, f4))
    mx = torch.maximum(torch.maximum(f1, f2), torch.maximum(f3, f4))
    shift = torch.clamp_min(-mn, 0.0) - torch.clamp_min(mx - 1.0, 0.0)
    f1, f2, f3, f4 = f1 + shift, f2 + shift, f3 + shift, f4 + shift
    mn = torch.minimum(torch.minimum(f1, f2), torch.minimum(f3, f4))
    mx = torch.maximum(torch.maximum(f1, f2), torch.maximum(f3, f4))
    ysc = torch.clamp(torch.minimum(1.0 - mx, mn)
                      / torch.clamp_min(torch.abs(tz), 1e-6), 0.0, 1.0)
    ytz = tz * ysc
    alive = 1.0 - s.rstf
    c1 = torch.clamp(f1 - ytz, 0.0, 1.0) * alive
    c2 = torch.clamp(f2 - ytz, 0.0, 1.0) * alive
    c3 = torch.clamp(f3 + ytz, 0.0, 1.0) * alive
    c4 = torch.clamp(f4 + ytz, 0.0, 1.0) * alive
    if motor_alpha > 0.0:
        s.r1 = motor_alpha * s.r1 + (1.0 - motor_alpha) * c1
        s.r2 = motor_alpha * s.r2 + (1.0 - motor_alpha) * c2
        s.r3 = motor_alpha * s.r3 + (1.0 - motor_alpha) * c3
        s.r4 = motor_alpha * s.r4 + (1.0 - motor_alpha) * c4
    else:
        s.r1, s.r2, s.r3, s.r4 = c1, c2, c3, c4
    r1, r2, r3, r4 = s.r1, s.r2, s.r3, s.r4

    fz = (r1 + r2 + r3 + r4) * ts_
    a_ = 2.0 * qw_ * qw_ - 1.0
    fwx = 2.0 * qw_ * (qy_ * fz) + 2.0 * qx_ * (qz_ * fz)
    fwy = 2.0 * qw_ * (-qx_ * fz) + 2.0 * qy_ * (qz_ * fz)
    fwz = a_ * fz + 2.0 * qz_ * (qz_ * fz)
    s.vx = s.vx + _DT * (fwx / mass)
    s.vy = s.vy + _DT * (fwy / mass)
    s.vz = s.vz + _DT * (fwz / mass - g)

    tbx = ts_ * L * (-r1 + r2 + r3 - r4)
    tby = -ts_ * L * (r1 - r2 + r3 - r4)
    tbz = tq * (-r1 - r2 + r3 + r4)
    gyx = wby * (izz * wbz) - wbz * (iyy * wby)
    gyy = wbz * (ixx * wbx) - wbx * (izz * wbz)
    gyz = wbx * (iyy * wby) - wby * (ixx * wbx)
    wbx_n = wbx + _DT * (tbx - gyx) / ixx
    wby_n = wby + _DT * (tby - gyy) / iyy
    wbz_n = wbz + _DT * (tbz - gyz) / izz

    wn = torch.sqrt(wbx_n * wbx_n + wby_n * wby_n + wbz_n * wbz_n)
    half = 0.5 * _DT * wn
    sinc = torch.where(half < 1e-8, one,
                       torch.sin(half) / torch.clamp_min(half, 1e-8))
    k_ = 0.5 * _DT * sinc
    dx, dy, dz, dw = k_ * wbx_n, k_ * wby_n, k_ * wbz_n, torch.cos(half)
    nqx = qw_ * dx + qx_ * dw + qy_ * dz - qz_ * dy
    nqy = qw_ * dy + qy_ * dw + qz_ * dx - qx_ * dz
    nqz = qw_ * dz + qz_ * dw + qx_ * dy - qy_ * dx
    nqw = qw_ * dw - qx_ * dx - qy_ * dy - qz_ * dz
    qn = 1.0 / torch.sqrt(nqx * nqx + nqy * nqy + nqz * nqz + nqw * nqw)
    qx, qy, qz, qw = nqx * qn, nqy * qn, nqz * qn, nqw * qn
    s.qx, s.qy, s.qz, s.qw = qx, qy, qz, qw

    s.px = s.px + _DT * s.vx
    s.py = s.py + _DT * s.vy
    s.pz = s.pz + _DT * s.vz
    a2_ = 2.0 * qw * qw - 1.0
    d = qx * wbx_n + qy * wby_n + qz * wbz_n
    s.wx = a2_ * wbx_n + 2.0 * qw * (qy * wbz_n - qz * wby_n) + 2.0 * d * qx
    s.wy = a2_ * wby_n + 2.0 * qw * (qz * wbx_n - qx * wbz_n) + 2.0 * d * qy
    s.wz = a2_ * wbz_n + 2.0 * qw * (qx * wby_n - qy * wbx_n) + 2.0 * d * qz
    s.prog = s.prog + 1.0
    return c1, c2, c3, c4


def yaw_of(s: Rows):
    """XYZ-euler yaw of the current attitude (pytorch3d convention)."""
    m00 = 1.0 - 2.0 * (s.qy * s.qy + s.qz * s.qz)
    m01 = 2.0 * (s.qx * s.qy - s.qw * s.qz)
    return tm.atan2(-m01, m00)


def ups_z(s: Rows):
    return 1.0 - 2.0 * (s.qx * s.qx + s.qy * s.qy)


def hover_reward(s: Rows, a0, a1, a2, a3, c):
    """Hovering reward (target: identity at the origin) and die flag,
    against the previous actions still in ``s.pa*``."""
    c1, c2, c3, c4 = c
    up = ups_z(s)
    effort_r = 0.1 * (4.0 - (c1 + c2 + c3 + c4)) / 4.0
    d0, d1, d2, d3 = a0 - s.pa0, a1 - s.pa1, a2 - s.pa2, a3 - s.pa3
    dn = torch.sqrt(d0 * d0 + d1 * d1 + d2 * d2)
    t3 = 3.0 * d3
    cont_r = 0.2 * torch.exp(-dn) + 0.5 / (1.0 + t3 * t3)
    thrust_r = 0.1 * (1.0 - torch.abs(0.1533 - a3))
    px, py, pz, vx, vy, vz = s.px, s.py, s.pz, s.vx, s.vy, s.vz
    dist = torch.sqrt(px * px + py * py + pz * pz)
    t16 = 1.6 * dist
    pos_r = 0.7 / (1.0 + t16 * t16)
    vn = torch.sqrt(vx * vx + vy * vy + vz * vz)
    dot = (-px * vx - py * vy - pz * vz) / torch.clamp_min(dist * vn, 1e-6)
    angle = torch.abs(tm.acos(torch.clamp(dot, -1.0, 1.0)))
    veldir_r = 0.1 * torch.exp(-angle / math.pi)
    ty = 3.0 * yaw_of(s) / math.pi
    yaw_r = 1.0 / (1.0 + ty * ty)
    ts3 = 3.0 * (s.wz * s.wz)
    spin_r = 1.0 / (1.0 + ts3 * ts3)
    tu = (up + 1.0) * 0.5
    ups_r = tu * tu
    reward = (cont_r + effort_r + thrust_r + pos_r
              + pos_r * (veldir_r + ups_r + spin_r + yaw_r))
    die = (dist > 4.0) | (pz < -2.0) | (pz > 2.0) | (up < 0.0)
    return reward, die


# reset distributions: (xy scale, z offset, z scale, roll, pitch, yaw
# scales in units of pi, pitch one-sided)
RESETS = {"hovering": (1.0, 0.0, 1.0, 0.01, 0.01, 0.05, False),
          "balloon": (0.1, 1.0, 0.2, 0.1, 0.1, 0.2, True),
          "tracking": (0.1, 1.0, 0.1, 0.1, 0.1, 0.2, False)}


def reset_root(draw, task: str = "hovering"):
    """12 reset draws -> the 13 root rows (pos, quat, linvel, angvel)."""
    sxy, z0, sz, e0, e1, e2, one_sided = RESETS[task]
    u = lambda: draw() * 2.0 - 1.0
    if task == "hovering":
        npx, npy, npz = u(), u(), u()
    else:
        npx, npy = sxy * u(), sxy * u()
        npz = z0 + sz * u()
    eax = e0 * math.pi * u()
    eay = e1 * math.pi * (draw() if one_sided else u())
    eaz = e2 * math.pi * u()
    rq = _quat_from_euler(eax, eay, eaz)
    v = [0.5 * u() for _ in range(3)]
    w = [0.2 * u() for _ in range(3)]
    return [npx, npy, npz, *rq, *v, *w]


def apply_reset(s: Rows, new_rstf, root) -> torch.Tensor:
    """Mix the reset draws in where ``new_rstf`` is 1 and zero the
    controller, action, rotor and progress rows; returns keep = 1 - flag."""
    keep = 1.0 - new_rstf
    for name, new in zip(Rows.NAMES[:13], root):
        setattr(s, name, getattr(s, name) * keep + new * new_rstf)
    for name in Rows.NAMES[13:19] + Rows.NAMES[21:]:
        setattr(s, name, getattr(s, name) * keep)
    s.prog = s.prog * keep
    s.rstf = new_rstf
    return keep


# ---------------------------------------------------------------------------
# env-only rollout


def _check(packed: torch.Tensor, action: torch.Tensor) -> None:
    if packed.dtype != torch.float32 or packed.dim() != 2 \
            or packed.shape[0] != _F:
        raise ValueError(f"packed state must be float32 [{_F}, N], got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    if packed.shape[1] % TILE:
        raise ValueError(f"N={packed.shape[1]} must be a multiple of {TILE}")
    if tuple(action.shape) != (4,) or action.dtype != torch.float32:
        raise ValueError(f"action must be float32 [4] (remapped rate "
                         f"action), got {action.dtype} {tuple(action.shape)}")


def rollout_fused(packed: torch.Tensor, action: torch.Tensor, seed: int,
                  steps: int, motor_alpha: float = 0.0):
    """[40, N] packed state + remapped rate action [4] -> (new packed
    state [40, N], per-env reward sums [N]) after ``steps`` env steps.
    motor_alpha = exp(-dt/motor_tau) (0.0 = instantaneous thrust). Rows
    29:40 pass through unchanged."""
    _check(packed, action)
    if not packed.is_cuda:
        return rollout_fused_plain(packed, action, seed, steps,
                                   motor_alpha=motor_alpha)
    n = packed.shape[1]
    s_in = packed.contiguous()
    a = [float(x) for x in action.cpu()]
    out = torch.empty_like(s_in)
    rew = torch.empty((n,), dtype=torch.float32, device=packed.device)
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    KERNEL.call("fused_hovering_launch", s_in.data_ptr(), *a,
                out.data_ptr(), rew.data_ptr(), n, steps,
                int(seed) & hr.M32, float(motor_alpha),
                float(1.0 - motor_alpha), int(motor_alpha > 0.0), stream)
    KERNEL.launches["env"] += 1
    return out, rew


def rollout_fused_plain(packed: torch.Tensor, action: torch.Tensor,
                        seed: int, steps: int, motor_alpha: float = 0.0):
    """Plain PyTorch version of ``csrc/fused_hovering.cu``."""
    n = packed.shape[1]
    base, lanes = rng_base(seed, n, packed.device)
    a0, a1, a2, a3 = (action[k] for k in range(4))
    thrust = torch.clamp(a3, _G.thrust_min, _G.thrust_max)
    s = Rows(packed)
    rew_sum = torch.zeros((n,), dtype=torch.float32, device=packed.device)
    for step_i in range(steps):
        c = control_physics(s, a0, a1, a2, thrust, motor_alpha,
                            env_only=True)
        reward, die = hover_reward(s, a0, a1, a2, a3, c)
        rew_sum = rew_sum + reward
        one = torch.ones_like(s.pa0)
        s.pa0, s.pa1, s.pa2, s.pa3 = a0 * one, a1 * one, a2 * one, a3 * one
        new_rstf = (die | (s.prog >= _HOVER_MAX_LEN - 1)).to(torch.float32)
        apply_reset(s, new_rstf,
                    reset_root(step_uniform(base, lanes, step_i)))
    out = packed.clone()
    out[0:NROWS] = s.stack()
    return out, rew_sum
