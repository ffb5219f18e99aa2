"""PX4-aligned cascaded flight controller (counterpart of
airgym_tpu/control/px4.py), batched over envs.

This slice ports the rate loop (CTBR: action = [p, q, r, thrust]) and the
X-quad mixer with PX4-style desaturation. Outputs are per-rotor thrust
commands in [0, 1]. The position, velocity, attitude and direct-rotor
modes are ROADMAP.md queue A item 3b and raise until then.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from airgym_tpu_torch.math import rotations as rot

CONTROL_MODES = ("pos", "vel", "atti", "rate", "prop")


class CascadeGains(NamedTuple):
    # body-rate PID (normalized torque output), PX4 MC_*RATE_*
    rate_p: tuple = (0.15, 0.15, 0.2)
    rate_i: tuple = (0.2, 0.2, 0.1)
    rate_d: tuple = (0.003, 0.003, 0.0)
    rate_int_lim: float = 0.30
    torque_lim: float = 1.0
    # attitude P (rad/s per rad), PX4 MC_ROLL/PITCH/YAW_P
    att_p: tuple = (6.5, 6.5, 2.8)
    rate_max: tuple = (3.8, 3.8, 3.5)
    # velocity PID (accel output), PX4 MPC_*_VEL_*_ACC
    vel_p: tuple = (1.8, 1.8, 4.0)
    vel_i: tuple = (0.4, 0.4, 2.0)
    vel_d: tuple = (0.2, 0.2, 0.0)
    vel_int_lim: float = 5.0
    # position P + velocity limits, PX4 MPC_XY/Z_P, MPC_*_VEL_MAX
    pos_p: tuple = (0.95, 0.95, 1.0)
    vel_max_xy: float = 12.0
    vel_max_up: float = 3.0
    vel_max_dn: float = 1.5
    max_tilt: float = 0.78
    thrust_min: float = 0.0
    thrust_max: float = 1.0
    mass: float = 0.601
    thrust_scale: float = 9.59
    gravity: float = 9.81


class CascadeState(NamedTuple):
    rate_int: torch.Tensor      # [N,3] body-rate integrator
    prev_rate: torch.Tensor     # [N,3] previous body rate
    vel_int: torch.Tensor       # [N,3] velocity integrator
    prev_vel_err: torch.Tensor  # [N,3] previous velocity error
    yaw_sp: torch.Tensor        # [N] integrated yaw setpoint


def init_state(n: int, dtype=torch.float32, device=None) -> CascadeState:
    z3 = torch.zeros((n, 3), dtype=dtype, device=device)
    return CascadeState(z3, z3.clone(), z3.clone(), z3.clone(),
                        torch.zeros((n,), dtype=dtype, device=device))


def reset_state(cs: CascadeState, reset_mask: torch.Tensor,
                quat_xyzw: torch.Tensor) -> CascadeState:
    """Zero the integrators of the envs being reset; re-anchor yaw."""
    m3 = reset_mask[:, None]
    zero = torch.zeros((), dtype=cs.rate_int.dtype,
                       device=cs.rate_int.device)
    return CascadeState(
        rate_int=torch.where(m3, zero, cs.rate_int),
        prev_rate=torch.where(m3, zero, cs.prev_rate),
        vel_int=torch.where(m3, zero, cs.vel_int),
        prev_vel_err=torch.where(m3, zero, cs.prev_vel_err),
        yaw_sp=torch.where(reset_mask, rot.yaw_from_quat(quat_xyzw),
                           cs.yaw_sp),
    )


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


def run(mode: str, g: CascadeGains, cs: CascadeState,
        root_state: torch.Tensor, action: torch.Tensor, dt: float = 0.01):
    """root_state [N,13] + mode action -> (rotor cmds [N,4], state)."""
    if mode != "rate":
        if mode not in CONTROL_MODES:
            raise ValueError(f"unknown control mode {mode!r}; "
                             f"expected {CONTROL_MODES}")
        raise NotImplementedError(
            f"ctl_mode {mode!r} is not ported yet: ROADMAP.md queue A "
            f"item 3b (px4 pos/vel/atti/prop)")
    quat = rot.quat_canonical(root_state[..., 3:7])
    angvel = root_state[..., 10:13]
    thrust = torch.clamp(action[..., 3], g.thrust_min, g.thrust_max)
    return rate_control(g, cs, quat, angvel, action[..., 0:3], thrust, dt)


def num_actions(mode: str) -> int:
    return 5 if mode == "atti" else 4


def action_limits(mode: str):
    """(lower, upper) action limits; rate mode: +-6 rad/s, thrust [0, 1]."""
    if mode != "rate":
        raise NotImplementedError(
            f"ctl_mode {mode!r} is not ported yet: ROADMAP.md queue A "
            f"item 3b (px4 pos/vel/atti/prop)")
    return np.array([-6.0, -6, -6, 0]), np.array([6.0, 6, 6, 1])
