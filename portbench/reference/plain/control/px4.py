"""The PX4 body-rate cascade in rate mode (CTBR: action = [p, q, r,
thrust]), the mode both configurations fly, batched over envs: body-rate
PID -> X-quad mixer with PX4-style desaturation. Outputs are per-rotor
thrust commands in [0, 1].
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.plain.math import rotations as rot


class CascadeGains(NamedTuple):
    # body-rate PID (normalized torque output), PX4 MC_*RATE_*
    rate_p: tuple = (0.15, 0.15, 0.2)
    rate_i: tuple = (0.2, 0.2, 0.1)
    rate_d: tuple = (0.003, 0.003, 0.0)
    rate_int_lim: float = 0.30
    torque_lim: float = 1.0
    thrust_min: float = 0.0
    thrust_max: float = 1.0


class CascadeState(NamedTuple):
    rate_int: torch.Tensor      # [N,3] body-rate integrator
    prev_rate: torch.Tensor     # [N,3] previous body rate


def init_state(n: int, dtype=torch.float32, device=None) -> CascadeState:
    z3 = torch.zeros((n, 3), dtype=dtype, device=device)
    return CascadeState(z3, z3.clone())


def reset_state(cs: CascadeState, reset_mask: torch.Tensor) -> CascadeState:
    """Zero the integrators of the envs being reset."""
    m3 = reset_mask[:, None]
    zero = torch.zeros((), dtype=cs.rate_int.dtype,
                       device=cs.rate_int.device)
    return CascadeState(rate_int=torch.where(m3, zero, cs.rate_int),
                        prev_rate=torch.where(m3, zero, cs.prev_rate))


def mix_to_rotors(g: CascadeGains, torque_norm: torch.Tensor,
                  thrust_norm: torch.Tensor) -> torch.Tensor:
    """Normalized body torques [N,3] + collective [N] -> rotor commands
    [N,4] in [0,1]: keep roll/pitch, then yaw with what margin is left."""
    tx, ty, tz = torque_norm[..., 0], torque_norm[..., 1], torque_norm[..., 2]
    rp = torch.stack([-tx - ty, tx + ty, tx - ty, -tx + ty], dim=-1)
    yaw = torch.stack([-tz, -tz, tz, tz], dim=-1)
    f = thrust_norm[..., None] + rp
    boost = torch.clamp_min(-torch.amin(f, dim=-1, keepdim=True), 0.0)
    reduce = torch.clamp_min(torch.amax(f, dim=-1, keepdim=True) - 1.0, 0.0)
    f = f + boost - reduce
    margin_hi = 1.0 - torch.amax(f, dim=-1, keepdim=True)
    margin_lo = torch.amin(f, dim=-1, keepdim=True)
    yaw_mag = torch.amax(torch.abs(yaw), dim=-1, keepdim=True)
    yaw_scale = torch.clamp(torch.minimum(margin_hi, margin_lo)
                            / torch.clamp_min(yaw_mag, 1e-6), 0.0, 1.0)
    return torch.clamp(f + yaw * yaw_scale, 0.0, 1.0)


def rate_control(g: CascadeGains, cs: CascadeState, quat_xyzw: torch.Tensor,
                 angvel_world: torch.Tensor, rate_sp: torch.Tensor,
                 thrust_norm: torch.Tensor, dt: float):
    """Body-rate PID -> mixer. rate_sp [N,3] body frame, thrust_norm [N]."""
    w_body = rot.quat_rotate_inverse(quat_xyzw, angvel_world)
    err = rate_sp - w_body
    kw = dict(dtype=err.dtype, device=err.device)
    kp = torch.tensor(g.rate_p, **kw)
    ki = torch.tensor(g.rate_i, **kw)
    kd = torch.tensor(g.rate_d, **kw)
    rate_int = torch.clamp(cs.rate_int + err * dt * ki,
                           -g.rate_int_lim, g.rate_int_lim)
    d_term = -(w_body - cs.prev_rate) / dt * kd
    torque = torch.clamp(kp * err + rate_int + d_term,
                         -g.torque_lim, g.torque_lim)
    cmds = mix_to_rotors(g, torque, thrust_norm)
    return cmds, cs._replace(rate_int=rate_int, prev_rate=w_body)


def run_rate(g: CascadeGains, cs: CascadeState, root_state: torch.Tensor,
             action: torch.Tensor, dt: float = 0.01):
    """root_state [N,13] + rate action -> (rotor cmds [N,4], state)."""
    quat = rot.quat_canonical(root_state[..., 3:7])
    thrust = torch.clamp(action[..., 3], g.thrust_min, g.thrust_max)
    return rate_control(g, cs, quat, root_state[..., 10:13],
                        action[..., 0:3], thrust, dt)


# default rate-mode action limits (lower, upper)
RATE_LIMITS = (np.array([-6.0, -6, -6, 0]), np.array([6.0, 6, 6, 1]))
