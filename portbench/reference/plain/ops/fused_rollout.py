"""The fused PPO rollout's plain version for Hovering: policy + env for
the whole horizon, the arithmetic and draw order of csrc/fused_rollout.cu.

Per step and env: the observation (18 state features with hash-RNG
Box-Muller noise), ``(x - mean) * istd`` clipped to +-5, the [64,128,64]
elu MLP to mu and value, the Gaussian sample and neglogp, clamp + remap,
the PX4 rate cascade, physics, the reward and kill rules and the hash-RNG
reset. The record [H, 18 + 13, N] holds obs(18) act(4) nlp value mu(4)
reward done timeout. The draws per step are 36 noise uniforms, 8 for the
sample and 12 for the reset.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from portbench.reference.plain.ops import fused_hovering as fhov

ACT = 4


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


def _elu(z):
    return torch.where(z > 0.0, z, torch.exp(torch.clamp_max(z, 0.0)) - 1.0)


def _observation(s: fhov.Rows, normal, obs_noise: bool):
    """The raw observation rows: 18 state features relative to the
    target (identity at the origin), noised."""
    qx, qy, qz, qw = s.qx, s.qy, s.qz, s.qw
    m = [1.0 - 2.0 * (qy * qy + qz * qz), 2.0 * (qx * qy - qw * qz),
         2.0 * (qx * qz + qw * qy), 2.0 * (qx * qy + qw * qz),
         1.0 - 2.0 * (qx * qx + qz * qz), 2.0 * (qy * qz - qw * qx),
         2.0 * (qx * qz - qw * qy), 2.0 * (qy * qz + qw * qx),
         1.0 - 2.0 * (qx * qx + qy * qy)]
    m[0], m[4], m[8] = m[0] - 1.0, m[4] - 1.0, m[8] - 1.0
    obs = m + [s.px, s.py, s.pz, s.vx, s.vy, s.vz, s.wx, s.wy, s.wz]
    if obs_noise:
        scales = [1e-3] * 9 + [5e-3] * 3 + [2e-2] * 3 + [4e-1] * 3
        obs = [o + sc * normal() for o, sc in zip(obs, scales)]
    return obs


def rollout_fused_policy(packed: torch.Tensor, pack: PolicyPack, seed: int,
                         steps: int, obs_noise: bool = True):
    """[40, N] packed env state + policy -> (new packed state [40, N],
    record [steps, 31, N]). ``seed`` is the int32 rollout seed."""
    n = packed.shape[1]
    w0, b0, w1, b1, w2, b2, wmu, bmu, wv, bv, logstd, obs_mean, obs_istd = \
        pack
    base, lanes = fhov.rng_base(seed, n, packed.device)
    LOG2PI = float(math.log(2.0 * math.pi))
    sig2 = torch.exp(logstd)                                   # [ACT, 1]
    ls = logstd[:, 0]
    lsum2 = ((ls[0] + ls[1]) + ls[2]) + ls[3]

    s = fhov.Rows(packed)
    recs = []
    for step_i in range(steps):
        draw = fhov.step_uniform(base, lanes, step_i)

        def normal():
            u1 = torch.clamp(draw(), 1e-7, 1.0)
            u2 = draw()
            return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
                2.0 * math.pi * u2)

        obs_f = _observation(s, normal, obs_noise)
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
        a_r = [torch.clamp(a_env[k], -6.0, 6.0) for k in range(3)]
        a_r.append(torch.clamp(0.5 + 0.5 * a_env[3], 0.0, 1.0))

        c = fhov.control_physics(s, a_r[0], a_r[1], a_r[2], a_r[3])
        reward, die = fhov.hover_reward(s, *a_r, c)
        s.pa0, s.pa1, s.pa2, s.pa3 = a_r
        over = s.prog >= fhov.HOVER_MAX_LEN - 1
        timeout = over & ~die
        new_rstf = (die | over).to(torch.float32)

        recs.append(torch.stack(
            obs_f + act_rows + [nlp, value] + [mu[k] for k in range(ACT)]
            + [reward, new_rstf, timeout.to(torch.float32)], dim=0))
        fhov.apply_reset(s, new_rstf, fhov.reset_root(draw))

    out = packed.clone()
    out[0:fhov.NROWS] = s.stack()
    return out, torch.stack(recs, dim=0)
