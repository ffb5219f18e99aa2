"""Fused PPO rollout: policy + env for the whole horizon in one kernel
(counterpart of airgym_tpu/ops/fused_rollout.py, task="hovering").

``rollout_fused_policy`` launches ``csrc/fused_rollout.cu`` for CUDA
tensors and runs ``rollout_fused_policy_plain`` for CPU tensors. The
plain version repeats the kernel's arithmetic and draw order; the tests
hold it against the Pallas kernel, and ``chip_smoke.py`` holds the CUDA
kernel against it.

Per step and env: the 18-dim observation with hash-RNG Box-Muller noise,
``(x - mean) * istd`` clipped to +-5, the [64,128,64] elu MLP to mu and
value, the Gaussian sample and neglogp, clamp + remap, the PX4 rate
cascade, physics, the hovering reward and the hash-RNG reset. The record
[H, 31, N] holds obs(18) act(4) nlp value mu(4) reward done timeout.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from airgym_tpu_torch.kernels import build
from airgym_tpu_torch.ops import fused_hovering as fhov
from airgym_tpu_torch.ops import transcendental as tm

TILE = fhov.TILE
_F = fhov._F
_DT = 0.01
_MAX_LEN = fhov._HOVER_MAX_LEN
_P = fhov._P
_G = fhov._G

OBS = 18
ACT = 4
H0, H1, H2 = 64, 128, 64
UNITS = (H0, H1, H2)
REC = 31

_TASK_OBS = {"hovering": 18, "balloon": 18, "tracking": 48}

KERNEL = build.CudaKernel("fused_rollout", {"fused_rollout_launch": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_int,
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]})


def rec_len(task: str = "hovering") -> int:
    return _TASK_OBS[task] + 13


class PolicyPack(NamedTuple):
    """Feature-major policy weights + obs stats (the JAX layout)."""
    w0: torch.Tensor      # [H0, OBS]
    b0: torch.Tensor      # [H0, 1]
    w1: torch.Tensor      # [H1, H0]
    b1: torch.Tensor
    w2: torch.Tensor      # [H2, H1]
    b2: torch.Tensor
    wmu: torch.Tensor     # [ACT, H2]
    bmu: torch.Tensor
    wv: torch.Tensor      # [1, H2]
    bv: torch.Tensor
    logstd: torch.Tensor  # [ACT, 1]
    obs_mean: torch.Tensor  # [OBS, 1]
    obs_istd: torch.Tensor  # [OBS, 1] = 1/sqrt(var + 1e-5)


def pack_policy(model, obs_rms) -> PolicyPack:
    """ActorCritic + RunningMeanStd -> PolicyPack. A torch Linear weight is
    already [out, in], the feature-major layout the kernel reads."""
    mlp = model.actor_mlp.layers
    t = lambda a: a.detach().to(torch.float32)
    col = lambda a: t(a).reshape(-1, 1)
    var32 = obs_rms.var.to(torch.float32)
    return PolicyPack(
        w0=t(mlp[0].weight), b0=col(mlp[0].bias),
        w1=t(mlp[1].weight), b1=col(mlp[1].bias),
        w2=t(mlp[2].weight), b2=col(mlp[2].bias),
        wmu=t(model.mu.weight), bmu=col(model.mu.bias),
        wv=t(model.value_head.weight), bv=col(model.value_head.bias),
        logstd=col(model.logstd),
        obs_mean=col(obs_rms.mean.to(torch.float32)),
        obs_istd=col(1.0 / torch.sqrt(var32 + 1e-5)))


def flat_policy(pack: PolicyPack) -> torch.Tensor:
    """The 18,157 floats the kernel stages in shared memory."""
    return torch.cat([x.reshape(-1) for x in pack]).contiguous()


def _check(packed: torch.Tensor, pack: PolicyPack, task: str) -> None:
    if task != "hovering":
        raise NotImplementedError(
            f"fused rollout task {task!r} is not ported yet: ROADMAP.md "
            f"queue B item 4 (balloon / tracking)")
    if packed.dtype != torch.float32 or packed.dim() != 2 \
            or packed.shape[0] != _F:
        raise ValueError(f"packed state must be float32 [{_F}, N], got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    if packed.shape[1] % TILE:
        raise ValueError(f"N={packed.shape[1]} must be a multiple of {TILE}")
    shapes = dict(w0=(H0, OBS), b0=(H0, 1), w1=(H1, H0), b1=(H1, 1),
                  w2=(H2, H1), b2=(H2, 1), wmu=(ACT, H2), bmu=(ACT, 1),
                  wv=(1, H2), bv=(1, 1), logstd=(ACT, 1), obs_mean=(OBS, 1),
                  obs_istd=(OBS, 1))
    for name, shape in shapes.items():
        x = getattr(pack, name)
        if tuple(x.shape) != shape or x.dtype != torch.float32 \
                or x.device != packed.device:
            raise ValueError(f"PolicyPack.{name}: want float32 {shape} on "
                             f"{packed.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")


def rollout_fused_policy(packed: torch.Tensor, pack: PolicyPack, seed: int,
                         steps: int, obs_noise: bool = True,
                         task: str = "hovering", motor_alpha: float = 0.0):
    """[40, N] packed env state + policy -> (new packed state [40, N],
    record [steps, 31, N]). ``seed`` is the int32 rollout seed;
    motor_alpha = exp(-dt/motor_tau) (0.0 = instantaneous thrust)."""
    _check(packed, pack, task)
    if not packed.is_cuda:
        return rollout_fused_policy_plain(packed, pack, seed, steps,
                                          obs_noise=obs_noise,
                                          motor_alpha=motor_alpha)
    n = packed.shape[1]
    s_in = packed.contiguous()
    weights = flat_policy(pack)
    out = torch.empty_like(s_in)
    rec = torch.empty((steps, REC, n), dtype=torch.float32,
                      device=packed.device)
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    KERNEL.call("fused_rollout_launch", s_in.data_ptr(), weights.data_ptr(),
                out.data_ptr(), rec.data_ptr(), n, steps,
                int(seed) & 0xFFFFFFFF, int(bool(obs_noise)),
                float(motor_alpha), float(1.0 - motor_alpha),
                int(motor_alpha > 0.0), stream)
    KERNEL.launches += 1
    return out, rec


def _rng_base(seed: int, n: int, device) -> tuple:
    env = torch.arange(n, dtype=torch.int64, device=device)
    tile = env // TILE
    base = ((int(seed) & fhov._M32) + fhov._mulmod(tile, 0x01000193)) \
        & fhov._M32
    return base, env % TILE


def rollout_fused_policy_plain(packed: torch.Tensor, pack: PolicyPack,
                               seed: int, steps: int, obs_noise: bool = True,
                               motor_alpha: float = 0.0):
    """Plain PyTorch version of ``csrc/fused_rollout.cu`` (hovering)."""
    n = packed.shape[1]
    dev = packed.device
    w0, b0, w1, b1, w2, b2, wmu, bmu, wv, bv, logstd, obs_mean, obs_istd = \
        pack
    base, lanes = _rng_base(seed, n, dev)
    LOG2PI = float(math.log(2.0 * math.pi))

    mass, g = _P.mass, _P.gravity
    ixx, iyy, izz = _P.inertia_diag
    ts_, tq = _P.thrust_scale, _P.torque_scale
    L = _P.rotor_pos[0][0]
    kp, ki, kd = _G.rate_p, _G.rate_i, _G.rate_d

    sig2 = torch.exp(logstd)                                   # [ACT, 1]
    ls = logstd[:, 0]
    lsum2 = ((ls[0] + ls[1]) + ls[2]) + ls[3]
    one = torch.ones((n,), dtype=torch.float32, device=dev)

    (px_, py_, pz_, qx, qy, qz, qw, vx, vy, vz, wx, wy, wz,
     rix, riy, riz, prx, pry, prz, prog, rstf,
     pa0, pa1, pa2, pa3, r1_, r2_, r3_, r4_) = [packed[i].clone()
                                               for i in range(29)]
    recs = []
    for step_i in range(steps):
        step_key = base ^ fhov._mulmod(step_i + 1, 0x9E3779B1)
        draw = fhov._make_uniform(step_key, lanes)

        def normal():
            u1 = torch.clamp(draw(), 1e-7, 1.0)
            u2 = draw()
            return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
                2.0 * math.pi * u2)

        # ---- observation --------------------------------------------------
        m00 = 1.0 - 2.0 * (qy * qy + qz * qz)
        m01 = 2.0 * (qx * qy - qw * qz)
        m02 = 2.0 * (qx * qz + qw * qy)
        m10 = 2.0 * (qx * qy + qw * qz)
        m11 = 1.0 - 2.0 * (qx * qx + qz * qz)
        m12 = 2.0 * (qy * qz - qw * qx)
        m20 = 2.0 * (qx * qz - qw * qy)
        m21 = 2.0 * (qy * qz + qw * qx)
        m22 = 1.0 - 2.0 * (qx * qx + qy * qy)
        obs_f = [m00 - 1.0, m01, m02, m10, m11 - 1.0, m12, m20, m21,
                 m22 - 1.0, px_, py_, pz_, vx, vy, vz, wx, wy, wz]
        if obs_noise:
            for i_, scale in enumerate([1e-3] * 9 + [5e-3] * 3 + [2e-2] * 3
                                       + [4e-1] * 3):
                obs_f[i_] = obs_f[i_] + scale * normal()

        X = torch.stack(obs_f, dim=0)                        # [OBS, N]
        Xn = torch.clamp((X - obs_mean) * obs_istd, -5.0, 5.0)

        def elu(z):
            return torch.where(z > 0.0, z,
                               torch.exp(torch.clamp_max(z, 0.0)) - 1.0)

        h = elu(w0 @ Xn + b0)
        h = elu(w1 @ h + b1)
        h = elu(w2 @ h + b2)
        mu = wmu @ h + bmu
        value = (wv @ h + bv)[0]

        # ---- sample + neglogp ---------------------------------------------
        eps = [normal() for _ in range(ACT)]
        act_rows = [mu[k] + sig2[k] * eps[k] for k in range(ACT)]
        nlp = (0.5 * (((eps[0] * eps[0] + eps[1] * eps[1]) + eps[2] * eps[2])
                      + eps[3] * eps[3]) + 0.5 * LOG2PI * ACT) + lsum2
        a_env = [torch.clamp(act_rows[k], -1.0, 1.0) for k in range(ACT)]
        a0r = torch.clamp(a_env[0], -6.0, 6.0)
        a1r = torch.clamp(a_env[1], -6.0, 6.0)
        a2r = torch.clamp(a_env[2], -6.0, 6.0)
        a3r = torch.clamp(0.5 + 0.5 * a_env[3], 0.0, 1.0)

        # ---- controller -----------------------------------------------------
        flip = torch.where(qw < 0.0, -one, one)
        qx_, qy_, qz_, qw_ = qx * flip, qy * flip, qz * flip, qw * flip

        def rot_inv(ax_, ay_, az_):
            a = 2.0 * qw_ * qw_ - 1.0
            cx_ = -qy_ * az_ + qz_ * ay_
            cy_ = -qz_ * ax_ + qx_ * az_
            cz_ = -qx_ * ay_ + qy_ * ax_
            d = -(qx_ * ax_ + qy_ * ay_ + qz_ * az_)
            return (a * ax_ + 2.0 * qw_ * cx_ - 2.0 * d * qx_,
                    a * ay_ + 2.0 * qw_ * cy_ - 2.0 * d * qy_,
                    a * az_ + 2.0 * qw_ * cz_ - 2.0 * d * qz_)

        wbx, wby, wbz = rot_inv(wx, wy, wz)

        def pid(err, integ, wprev, wnow, kp_, ki_, kd_):
            integ = torch.clamp(integ + err * _DT * ki_,
                                -_G.rate_int_lim, _G.rate_int_lim)
            d = -(wnow - wprev) / _DT * kd_
            return torch.clamp(kp_ * err + integ + d,
                               -_G.torque_lim, _G.torque_lim), integ

        tx, rix = pid(a0r - wbx, rix, prx, wbx, kp[0], ki[0], kd[0])
        ty, riy = pid(a1r - wby, riy, pry, wby, kp[1], ki[1], kd[1])
        tz, riz = pid(a2r - wbz, riz, prz, wbz, kp[2], ki[2], kd[2])
        prx, pry, prz = wbx, wby, wbz

        thrust = a3r
        f1, f2, f3, f4 = (thrust - tx - ty, thrust + tx + ty,
                          thrust + tx - ty, thrust - tx + ty)
        mn = torch.minimum(torch.minimum(f1, f2), torch.minimum(f3, f4))
        mx = torch.maximum(torch.maximum(f1, f2), torch.maximum(f3, f4))
        shift = torch.clamp_min(-mn, 0.0) - torch.clamp_min(mx - 1.0, 0.0)
        f1, f2, f3, f4 = f1 + shift, f2 + shift, f3 + shift, f4 + shift
        mn = torch.minimum(torch.minimum(f1, f2), torch.minimum(f3, f4))
        mx = torch.maximum(torch.maximum(f1, f2), torch.maximum(f3, f4))
        ysc = torch.clamp(torch.minimum(1.0 - mx, mn)
                          / torch.clamp_min(torch.abs(tz), 1e-6), 0.0, 1.0)
        ytz = tz * ysc
        alive = 1.0 - rstf
        c1 = torch.clamp(f1 - ytz, 0.0, 1.0) * alive
        c2 = torch.clamp(f2 - ytz, 0.0, 1.0) * alive
        c3 = torch.clamp(f3 + ytz, 0.0, 1.0) * alive
        c4 = torch.clamp(f4 + ytz, 0.0, 1.0) * alive
        if motor_alpha > 0.0:
            r1_ = motor_alpha * r1_ + (1.0 - motor_alpha) * c1
            r2_ = motor_alpha * r2_ + (1.0 - motor_alpha) * c2
            r3_ = motor_alpha * r3_ + (1.0 - motor_alpha) * c3
            r4_ = motor_alpha * r4_ + (1.0 - motor_alpha) * c4
        else:
            r1_, r2_, r3_, r4_ = c1, c2, c3, c4

        # ---- physics --------------------------------------------------------
        fz = (r1_ + r2_ + r3_ + r4_) * ts_
        a_ = 2.0 * qw_ * qw_ - 1.0
        fwx = 2.0 * qw_ * (qy_ * fz) + 2.0 * qx_ * (qz_ * fz)
        fwy = 2.0 * qw_ * (-qx_ * fz) + 2.0 * qy_ * (qz_ * fz)
        fwz = a_ * fz + 2.0 * qz_ * (qz_ * fz)
        vx = vx + _DT * (fwx / mass)
        vy = vy + _DT * (fwy / mass)
        vz = vz + _DT * (fwz / mass - g)

        tbx = ts_ * L * (-r1_ + r2_ + r3_ - r4_)
        tby = -ts_ * L * (r1_ - r2_ + r3_ - r4_)
        tbz = tq * (-r1_ - r2_ + r3_ + r4_)
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

        px_ = px_ + _DT * vx
        py_ = py_ + _DT * vy
        pz_ = pz_ + _DT * vz

        def rot_fwd(ax_, ay_, az_):
            a2_ = 2.0 * qw * qw - 1.0
            cx_ = qy * az_ - qz * ay_
            cy_ = qz * ax_ - qx * az_
            cz_ = qx * ay_ - qy * ax_
            d = qx * ax_ + qy * ay_ + qz * az_
            return (a2_ * ax_ + 2.0 * qw * cx_ + 2.0 * d * qx,
                    a2_ * ay_ + 2.0 * qw * cy_ + 2.0 * d * qy,
                    a2_ * az_ + 2.0 * qw * cz_ + 2.0 * d * qz)

        wx, wy, wz = rot_fwd(wbx_n, wby_n, wbz_n)
        prog = prog + 1.0

        # ---- hovering reward ---------------------------------------------------
        ups_z = 1.0 - 2.0 * (qx * qx + qy * qy)
        effort_r = 0.1 * (4.0 - (c1 + c2 + c3 + c4)) / 4.0
        d0, d1, d2, d3 = a0r - pa0, a1r - pa1, a2r - pa2, a3r - pa3
        dn = torch.sqrt(d0 * d0 + d1 * d1 + d2 * d2)
        t3 = 3.0 * d3
        cont_r = 0.2 * torch.exp(-dn) + 0.5 / (1.0 + t3 * t3)
        thrust_r = 0.1 * (1.0 - torch.abs(0.1533 - a3r))
        dist = torch.sqrt(px_ * px_ + py_ * py_ + pz_ * pz_)
        t16 = 1.6 * dist
        pos_r = 0.7 / (1.0 + t16 * t16)
        vn2 = torch.sqrt(vx * vx + vy * vy + vz * vz)
        dot = (-px_ * vx - py_ * vy - pz_ * vz) / torch.clamp_min(
            dist * vn2, 1e-6)
        angle = torch.abs(tm.acos(torch.clamp(dot, -1.0, 1.0)))
        veldir_r = 0.1 * torch.exp(-angle / math.pi)
        nm00 = 1.0 - 2.0 * (qy * qy + qz * qz)
        nm01 = 2.0 * (qx * qy - qw * qz)
        yawang = tm.atan2(-nm01, nm00)
        ty_ = 3.0 * yawang / math.pi
        yaw_r = 1.0 / (1.0 + ty_ * ty_)
        spin = wz * wz
        ts3 = 3.0 * spin
        spin_r = 1.0 / (1.0 + ts3 * ts3)
        tu = (ups_z + 1.0) * 0.5
        ups_r = tu * tu
        reward = (cont_r + effort_r + thrust_r + pos_r
                  + pos_r * (veldir_r + ups_r + spin_r + yaw_r))
        die = (dist > 4.0) | (pz_ < -2.0) | (pz_ > 2.0) | (ups_z < 0.0)
        pa0, pa1, pa2, pa3 = a0r, a1r, a2r, a3r
        over = prog >= _MAX_LEN - 1
        timeout = over & ~die
        new_rstf = (die | over).to(torch.float32)

        recs.append(torch.stack(
            obs_f + act_rows + [nlp, value] + [mu[k] for k in range(ACT)]
            + [reward, new_rstf, timeout.to(torch.float32)], dim=0))

        # ---- hash-RNG reset ------------------------------------------------------
        keep = 1.0 - new_rstf
        u = lambda: draw() * 2.0 - 1.0
        npx, npy, npz = u(), u(), u()
        eax = 0.01 * math.pi * u()
        eay = 0.01 * math.pi * u()
        eaz = 0.05 * math.pi * u()
        rqx, rqy, rqz, rqw = fhov._quat_from_euler(eax, eay, eaz)
        nvx, nvy, nvz = 0.5 * u(), 0.5 * u(), 0.5 * u()
        nwx, nwy, nwz = 0.2 * u(), 0.2 * u(), 0.2 * u()

        def mix(old, new):
            return old * keep + new * new_rstf

        px_, py_, pz_ = mix(px_, npx), mix(py_, npy), mix(pz_, npz)
        qx, qy, qz, qw = (mix(qx, rqx), mix(qy, rqy), mix(qz, rqz),
                          mix(qw, rqw))
        vx, vy, vz = mix(vx, nvx), mix(vy, nvy), mix(vz, nvz)
        wx, wy, wz = mix(wx, nwx), mix(wy, nwy), mix(wz, nwz)
        rix, riy, riz = rix * keep, riy * keep, riz * keep
        prx, pry, prz = prx * keep, pry * keep, prz * keep
        pa0, pa1, pa2, pa3 = pa0 * keep, pa1 * keep, pa2 * keep, pa3 * keep
        r1_, r2_, r3_, r4_ = r1_ * keep, r2_ * keep, r3_ * keep, r4_ * keep
        prog = prog * keep
        rstf = new_rstf

    out = packed.clone()
    out[0:29] = torch.stack([px_, py_, pz_, qx, qy, qz, qw, vx, vy, vz,
                             wx, wy, wz, rix, riy, riz, prx, pry, prz,
                             prog, rstf, pa0, pa1, pa2, pa3,
                             r1_, r2_, r3_, r4_], dim=0)
    rec = (torch.stack(recs, dim=0) if recs else
           torch.empty((0, REC, n), dtype=torch.float32, device=dev))
    return out, rec
