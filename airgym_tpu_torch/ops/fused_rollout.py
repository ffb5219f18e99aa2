"""Fused PPO rollout: policy + env for the whole horizon in one kernel
(counterpart of airgym_tpu/ops/fused_rollout.py, tasks hovering, balloon
and tracking).

``rollout_fused_policy`` launches ``csrc/fused_rollout.cu`` (one
instance per task) for CUDA tensors and runs ``rollout_fused_policy_plain``
for CPU tensors. The plain version repeats the kernel's arithmetic and
draw order; the tests hold it against the Pallas kernel, and
``chip_smoke.py`` holds the CUDA kernel against it.

Per step and env: the observation (18 state features with hash-RNG
Box-Muller noise; Tracking adds 30 noise-free reference features),
``(x - mean) * istd`` clipped to +-5, the [64,128,64] elu MLP to mu and
value, the Gaussian sample and neglogp, clamp + remap, the PX4 rate
cascade, physics, the task's reward and kill rules and the hash-RNG
reset. The record [H, OBS + 13, N] holds obs(OBS) act(4) nlp value mu(4)
reward done timeout.

Per task: Hovering and Tracking own state rows 0:29, Balloon also the
balloon position (29:32) and pre_root_pos (32:35); Balloon limits the
body rates to +-1 rad/s; the draws per step are 36 noise uniforms, 8 for
the sample and 12 for the reset (Balloon: 15, with its balloon).
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

ACT = 4
H0, H1, H2 = 64, 128, 64
UNITS = (H0, H1, H2)

_TASK_OBS = {"hovering": 18, "balloon": 18, "tracking": 48}
# episode lengths (episode_length_s / dt) and the kernel's task index
_TASK_MAX_LEN = {"hovering": fhov._HOVER_MAX_LEN, "balloon": 800,
                 "tracking": 3600}
_TASK_ID = {"hovering": 0, "balloon": 1, "tracking": 2}

KERNEL = build.CudaKernel("fused_rollout", {
    "fused_rollout_launch": [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p],
    "fused_rollout_shape": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]})


def rec_len(task: str = "hovering") -> int:
    return _TASK_OBS[task] + 13


class PolicyPack(NamedTuple):
    """Feature-major policy weights + obs stats (the JAX layout)."""
    w0: torch.Tensor      # [H0, obs]
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
    obs_mean: torch.Tensor  # [obs, 1]
    obs_istd: torch.Tensor  # [obs, 1] = 1/sqrt(var + 1e-5)


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
    """The floats the kernel stages in shared memory: 18,157 at 18
    observation features, 20,137 at 48."""
    return torch.cat([x.reshape(-1) for x in pack]).contiguous()


def pack_state_balloon(core, balloon, pre_root_pos) -> torch.Tensor:
    """Balloon: hovering's 29 rows + balloon position (29:32) +
    pre_root_pos (32:35) in the same [40, N] record."""
    s = fhov.pack_state(core)
    s[29:32] = balloon[:, 0:3].T
    s[32:35] = pre_root_pos.T
    return s


def _check(packed: torch.Tensor, pack: PolicyPack, task: str) -> None:
    if task not in _TASK_OBS:
        raise NotImplementedError(
            f"fused rollout task {task!r} has no fused kernel (tasks: "
            f"{sorted(_TASK_OBS)}); other tasks train with the plain "
            f"rl/ppo.PPO rollout (ROADMAP.md queue F item 3)")
    obs = _TASK_OBS[task]
    if packed.dtype != torch.float32 or packed.dim() != 2 \
            or packed.shape[0] != _F:
        raise ValueError(f"packed state must be float32 [{_F}, N], got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    if packed.shape[1] % TILE:
        raise ValueError(f"N={packed.shape[1]} must be a multiple of {TILE}")
    shapes = dict(w0=(H0, obs), b0=(H0, 1), w1=(H1, H0), b1=(H1, 1),
                  w2=(H2, H1), b2=(H2, 1), wmu=(ACT, H2), bmu=(ACT, 1),
                  wv=(1, H2), bv=(1, 1), logstd=(ACT, 1), obs_mean=(obs, 1),
                  obs_istd=(obs, 1))
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
    record [steps, rec_len(task), N]). ``seed`` is the int32 rollout
    seed; motor_alpha = exp(-dt/motor_tau) (0.0 = instantaneous
    thrust). Rows the task does not own pass through unchanged."""
    _check(packed, pack, task)
    if not packed.is_cuda:
        return rollout_fused_policy_plain(packed, pack, seed, steps,
                                          obs_noise=obs_noise, task=task,
                                          motor_alpha=motor_alpha)
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    return _kernel_rollout(KERNEL, stream, packed, pack, seed, steps,
                           obs_noise, task, motor_alpha)


def _kernel_rollout(kernel, stream, packed, pack, seed, steps, obs_noise,
                    task, motor_alpha):
    """One launch of ``kernel`` on ``stream``, its outputs on ``packed``'s
    device (a CPU build of the source takes CPU tensors and no stream)."""
    n = packed.shape[1]
    s_in = packed.contiguous()
    weights = flat_policy(pack)
    out = torch.empty_like(s_in)
    rec = torch.empty((steps, rec_len(task), n), dtype=torch.float32,
                      device=packed.device)
    kernel.call("fused_rollout_launch", _TASK_ID[task], s_in.data_ptr(),
                weights.data_ptr(), out.data_ptr(), rec.data_ptr(), n,
                steps, int(seed) & 0xFFFFFFFF, int(bool(obs_noise)),
                float(motor_alpha), float(1.0 - motor_alpha),
                int(motor_alpha > 0.0), stream)
    kernel.launches[task] += 1
    return out, rec


def launch_shape(task: str, n: int) -> dict:
    """The kernel's launch at n envs on the current card: envs and
    threads per block, blocks, resident blocks per SM (the occupancy
    calculator's) and dynamic shared memory bytes per block."""
    out = (ctypes.c_int * 5)()
    KERNEL.call("fused_rollout_shape", _TASK_ID[task], n, out)
    return dict(zip(("envs", "threads", "blocks", "per_sm", "smem"), out))


def _elu(z):
    return torch.where(z > 0.0, z, torch.exp(torch.clamp_max(z, 0.0)) - 1.0)


def _observation(s: fhov.Rows, task: str, extras, normal, obs_noise: bool):
    """The raw observation rows: 18 state features (noised) and, for
    Tracking, 10 lemniscate points relative to the drone (noise-free,
    at the progress before this step's increment)."""
    qx, qy, qz, qw = s.qx, s.qy, s.qz, s.qw
    m = [1.0 - 2.0 * (qy * qy + qz * qz), 2.0 * (qx * qy - qw * qz),
         2.0 * (qx * qz + qw * qy), 2.0 * (qx * qy + qw * qz),
         1.0 - 2.0 * (qx * qx + qz * qz), 2.0 * (qy * qz - qw * qx),
         2.0 * (qx * qz - qw * qy), 2.0 * (qy * qz + qw * qx),
         1.0 - 2.0 * (qx * qx + qy * qy)]
    if task != "tracking":              # rotation relative to identity
        m[0], m[4], m[8] = m[0] - 1.0, m[4] - 1.0, m[8] - 1.0
    if task == "balloon":               # position relative to the balloon
        pos = [s.px - extras[0], s.py - extras[1], s.pz - extras[2]]
    else:
        pos = [s.px, s.py, s.pz]
    obs = m + pos + [s.vx, s.vy, s.vz, s.wx, s.wy, s.wz]
    if obs_noise:
        scales = [1e-3] * 9 + [5e-3] * 3 + [2e-2] * 3 + [4e-1] * 3
        obs = [o + sc * normal() for o, sc in zip(obs, scales)]
    if task == "tracking":
        for i in range(10):
            t_ref = (s.prog + float(i * 5)) * (_DT * 0.25)
            st, ct = torch.sin(t_ref), torch.cos(t_ref)
            den = 1.0 + ct * ct
            obs += [3.0 * st / den - s.px, 3.0 * st * ct / den - s.py,
                    1.0 - s.pz]
    return obs


def _tracking_reward(s: fhov.Rows, a, c):
    c1, c2, c3, c4 = c
    a0r, a1r, a2r, a3r = a
    effort_r = 0.1 * (4.0 - (c1 + c2 + c3 + c4)) / 4.0
    d0, d1, d2, d3 = a0r - s.pa0, a1r - s.pa1, a2r - s.pa2, a3r - s.pa3
    dn = torch.sqrt(d0 * d0 + d1 * d1 + d2 * d2)
    t2 = 2.0 * d3
    cont_r = 0.1 * torch.exp(-dn) + 0.5 / (1.0 + t2 * t2)
    thrust_r = 0.1 * (1.0 - torch.abs(0.1533 - a3r))
    # the reference point at the incremented progress
    t_ref = s.prog * (_DT * 0.25)
    st, ct = torch.sin(t_ref), torch.cos(t_ref)
    den = 1.0 + ct * ct
    ex = 3.0 * st / den - s.px
    ey = 3.0 * st * ct / den - s.py
    ez = 1.0 - s.pz
    dist = torch.sqrt(ex * ex + ey * ey + ez * ez)
    t18 = 1.8 * dist
    dist_r = 1.0 / (1.0 + t18 * t18)
    ty = 4.0 * fhov.yaw_of(s) / math.pi
    yaw_r = 1.0 / (1.0 + ty * ty)
    ts2 = 2.0 * (s.wz * s.wz)
    spin_r = 1.0 / (1.0 + ts2 * ts2)
    tu = (fhov.ups_z(s) + 1.0) * 0.5
    ups_r = tu * tu
    reward = (cont_r + effort_r + thrust_r + dist_r
              + dist_r * (spin_r + yaw_r + ups_r))
    return reward, dist > 1.0


def _balloon_reward(s: fhov.Rows, a, extras):
    a0r, a1r, a2r, a3r = a
    bx, by, bz, ppx, ppy, ppz = extras
    relx, rely, relz = bx - s.px, by - s.py, bz - s.pz
    check = torch.sqrt(relx * relx + rely * rely + relz * relz)
    dyaw = fhov.yaw_of(s) - tm.atan2(rely, relx)
    t16 = 1.6 * torch.abs(tm.atan2(torch.sin(dyaw), torch.cos(dyaw)))
    yaw_r = 1.0 / (1.0 + t16 * t16)
    dpx, dpy, dpz = bx - ppx, by - ppy, bz - ppz
    guidance_r = 30.0 * (torch.sqrt(dpx * dpx + dpy * dpy + dpz * dpz)
                         - check)
    tu = (fhov.ups_z(s) + 1.0) * 0.5
    ups_r = 0.5 * (tu * tu)
    hit = check < 0.1
    hit_r = 800.0 * hit.to(torch.float32)
    effort_r = 0.1 * torch.exp(-(a0r * a0r + a1r * a1r + a2r * a2r
                                 + a3r * a3r))
    d0, d1, d2, d3 = a0r - s.pa0, a1r - s.pa1, a2r - s.pa2, a3r - s.pa3
    smooth_r = 0.1 * torch.exp(-torch.sqrt(d0 * d0 + d1 * d1 + d2 * d2
                                           + d3 * d3))
    reward = guidance_r + yaw_r + hit_r + smooth_r + ups_r + effort_r
    # kill rules + ground collision (base sphere of 0.2 m)
    die = ((relx < -0.2) | (s.vx < 0.0) | (check > 4.0) | (s.pz < 0.5)
           | (s.pz > 1.5) | hit | (s.pz < 0.2))
    return reward, die


def rollout_fused_policy_plain(packed: torch.Tensor, pack: PolicyPack,
                               seed: int, steps: int, obs_noise: bool = True,
                               task: str = "hovering",
                               motor_alpha: float = 0.0):
    """Plain PyTorch version of ``csrc/fused_rollout.cu``."""
    n = packed.shape[1]
    dev = packed.device
    w0, b0, w1, b1, w2, b2, wmu, bmu, wv, bv, logstd, obs_mean, obs_istd = \
        pack
    base, lanes = fhov.rng_base(seed, n, dev)
    LOG2PI = float(math.log(2.0 * math.pi))
    sig2 = torch.exp(logstd)                                   # [ACT, 1]
    ls = logstd[:, 0]
    lsum2 = ((ls[0] + ls[1]) + ls[2]) + ls[3]
    rate_lim = 1.0 if task == "balloon" else 6.0
    max_len = _TASK_MAX_LEN[task]

    s = fhov.Rows(packed)
    extras = [packed[i].clone() for i in range(29, 35)]  # balloon only
    recs = []
    for step_i in range(steps):
        draw = fhov.step_uniform(base, lanes, step_i)

        def normal():
            u1 = torch.clamp(draw(), 1e-7, 1.0)
            u2 = draw()
            return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
                2.0 * math.pi * u2)

        obs_f = _observation(s, task, extras, normal, obs_noise)
        X = torch.stack(obs_f, dim=0)                        # [OBS, N]
        Xn = torch.clamp((X - obs_mean) * obs_istd, -5.0, 5.0)
        h = _elu(w0 @ Xn + b0)
        h = _elu(w1 @ h + b1)
        h = _elu(w2 @ h + b2)
        mu = wmu @ h + bmu
        value = (wv @ h + bv)[0]

        eps = [normal() for _ in range(ACT)]
        act_rows = [mu[k] + sig2[k] * eps[k] for k in range(ACT)]
        nlp = (0.5 * (((eps[0] * eps[0] + eps[1] * eps[1]) + eps[2] * eps[2])
                      + eps[3] * eps[3]) + 0.5 * LOG2PI * ACT) + lsum2
        a_env = [torch.clamp(act_rows[k], -1.0, 1.0) for k in range(ACT)]
        a_r = [torch.clamp(a_env[k], -rate_lim, rate_lim) for k in range(3)]
        a_r.append(torch.clamp(0.5 + 0.5 * a_env[3], 0.0, 1.0))

        c = fhov.control_physics(s, a_r[0], a_r[1], a_r[2], a_r[3],
                                 motor_alpha)
        if task == "hovering":
            reward, die = fhov.hover_reward(s, *a_r, c)
        elif task == "tracking":
            reward, die = _tracking_reward(s, a_r, c)
        else:
            reward, die = _balloon_reward(s, a_r, extras)
            extras[3:6] = [s.px, s.py, s.pz]   # pre_root_pos after the reward
        s.pa0, s.pa1, s.pa2, s.pa3 = a_r
        over = s.prog >= max_len - 1
        timeout = over & ~die
        new_rstf = (die | over).to(torch.float32)

        recs.append(torch.stack(
            obs_f + act_rows + [nlp, value] + [mu[k] for k in range(ACT)]
            + [reward, new_rstf, timeout.to(torch.float32)], dim=0))

        root = fhov.reset_root(draw, task)
        if task == "balloon":
            u = lambda: draw() * 2.0 - 1.0
            nb = [2.5 + 0.5 * u(), 2.0 * u(), 1.0 + 0.3 * u()]
        keep = fhov.apply_reset(s, new_rstf, root)
        if task == "balloon":
            extras[0:3] = [b * keep + nb_ * new_rstf
                           for b, nb_ in zip(extras[0:3], nb)]
            extras[3:6] = [p * keep for p in extras[3:6]]

    out = packed.clone()
    out[0:fhov.NROWS] = s.stack()
    if task == "balloon":
        out[29:35] = torch.stack(extras, dim=0)
    rec = (torch.stack(recs, dim=0) if recs else
           torch.empty((0, rec_len(task), n), dtype=torch.float32,
                       device=dev))
    return out, rec
