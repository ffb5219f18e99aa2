"""PX4-aligned cascaded flight controller (counterpart of
airgym_tpu/control/px4.py), batched over envs.

The five control modes of the reference (``run``):
  * ``pos``  (PY):   action = [x, y, z, yaw]            -> rotor cmds
  * ``vel``  (LV):   action = [vx, vy, vz, yaw_rate]    -> rotor cmds
  * ``atti`` (CTA):  action = [qw, qx, qy, qz, thrust]  -> rotor cmds
  * ``rate`` (CTBR): action = [p, q, r, thrust]         -> rotor cmds
  * ``prop`` (SRT):  action = per-rotor thrusts, bypass.
The cascade is position P -> velocity PID -> geometric attitude P ->
body-rate PID -> X-quad mixer with PX4-style desaturation. Outputs are
per-rotor thrust commands in [0, 1].
"""
from __future__ import annotations

from typing import NamedTuple, Optional

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


def attitude_rates(g: CascadeGains, quat_xyzw: torch.Tensor,
                   quat_sp_xyzw: torch.Tensor,
                   yaw_rate_ff: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Quaternion attitude error -> body-rate setpoint (PX4 geometric P)."""
    q_err = rot.quat_mul(rot.quat_conjugate(rot.quat_normalize(quat_xyzw)),
                         rot.quat_normalize(quat_sp_xyzw))
    q_err = rot.quat_canonical(q_err)
    att_e = 2.0 * q_err[..., :3]              # small-angle body-frame error
    kw = dict(dtype=att_e.dtype, device=att_e.device)
    rate_sp = torch.tensor(g.att_p, **kw) * att_e
    if yaw_rate_ff is not None:
        rate_sp = torch.cat([rate_sp[..., :2],
                             rate_sp[..., 2:3] + yaw_rate_ff[..., None]],
                            dim=-1)
    lim = torch.tensor(g.rate_max, **kw)
    return torch.minimum(torch.maximum(rate_sp, -lim), lim)


def _accel_to_att_thrust(g: CascadeGains, acc_sp: torch.Tensor,
                         yaw_sp: torch.Tensor):
    """Desired world acceleration -> (quat setpoint xyzw, collective cmd).

    f = acc_sp + g e_z is the specific force the rotors must supply; its
    direction is body z, the yaw setpoint fixes body x (the geometric
    construction). The tilt is limited before the orientation is built.
    """
    zero = torch.zeros_like(yaw_sp)
    f = acc_sp + torch.stack([zero, zero, torch.full_like(yaw_sp, g.gravity)],
                             dim=-1)
    fz = torch.clamp_min(f[..., 2], 1e-3)
    tan_tilt = torch.tan(torch.tensor(g.max_tilt, dtype=f.dtype,
                                      device=f.device))
    max_xy = tan_tilt * fz
    f_xy = f[..., :2]
    xy_norm = torch.linalg.norm(f_xy, dim=-1, keepdim=True)
    scale = torch.clamp_max(max_xy[..., None]
                            / torch.clamp_min(xy_norm, 1e-6), 1.0)
    f = torch.cat([f_xy * scale, fz[..., None]], dim=-1)

    f_norm = torch.linalg.norm(f, dim=-1)
    b3 = f / torch.clamp_min(f_norm[..., None], 1e-6)
    xc = torch.stack([torch.cos(yaw_sp), torch.sin(yaw_sp), zero], dim=-1)
    b2 = torch.linalg.cross(b3, xc, dim=-1)
    b2 = b2 / torch.clamp_min(torch.linalg.norm(b2, dim=-1, keepdim=True),
                              1e-6)
    b1 = torch.linalg.cross(b2, b3, dim=-1)
    quat_sp = rot.matrix_to_quat(torch.stack([b1, b2, b3], dim=-1))
    thrust_norm = torch.clamp(f_norm * g.mass / (4.0 * g.thrust_scale),
                              g.thrust_min, g.thrust_max)
    return quat_sp, thrust_norm


def velocity_control(g: CascadeGains, cs: CascadeState, vel: torch.Tensor,
                     vel_sp: torch.Tensor, yaw_sp: torch.Tensor, dt: float):
    """Velocity PID -> (quat_sp, thrust_norm, new controller state)."""
    err = vel_sp - vel
    kw = dict(dtype=err.dtype, device=err.device)
    kp = torch.tensor(g.vel_p, **kw)
    ki = torch.tensor(g.vel_i, **kw)
    kd = torch.tensor(g.vel_d, **kw)
    vel_int = torch.clamp(cs.vel_int + err * dt * ki,
                          -g.vel_int_lim, g.vel_int_lim)
    d_term = (err - cs.prev_vel_err) / dt * kd
    acc_sp = kp * err + vel_int + d_term
    quat_sp, thrust_norm = _accel_to_att_thrust(g, acc_sp, yaw_sp)
    return quat_sp, thrust_norm, cs._replace(vel_int=vel_int,
                                             prev_vel_err=err)


def run(mode: str, g: CascadeGains, cs: CascadeState,
        root_state: torch.Tensor, action: torch.Tensor, dt: float = 0.01):
    """root_state [N,13] + mode action -> (rotor cmds [N,4], state)."""
    pos = root_state[..., 0:3]
    quat = rot.quat_canonical(root_state[..., 3:7])
    vel = root_state[..., 7:10]
    angvel = root_state[..., 10:13]

    if mode == "prop":
        return torch.clamp(action, 0.0, 1.0), cs

    if mode == "rate":
        thrust = torch.clamp(action[..., 3], g.thrust_min, g.thrust_max)
        return rate_control(g, cs, quat, angvel, action[..., 0:3], thrust,
                            dt)

    if mode == "atti":
        q_sp = rot.quat_normalize(rot.wxyz_to_xyzw(action[..., 0:4]))
        thrust = torch.clamp(action[..., 4], g.thrust_min, g.thrust_max)
        rate_sp = attitude_rates(g, quat, q_sp)
        return rate_control(g, cs, quat, angvel, rate_sp, thrust, dt)

    if mode == "vel":
        # the yaw setpoint integrates the commanded yaw rate
        yaw_rate = action[..., 3]
        yaw_sp = rot.wrap_angle(cs.yaw_sp + yaw_rate * dt)
        cs = cs._replace(yaw_sp=yaw_sp)
        quat_sp, thrust, cs = velocity_control(g, cs, vel, action[..., 0:3],
                                               yaw_sp, dt)
        rate_sp = attitude_rates(g, quat, quat_sp, yaw_rate_ff=yaw_rate)
        return rate_control(g, cs, quat, angvel, rate_sp, thrust, dt)

    if mode == "pos":
        # absolute position and yaw setpoints; the velocity setpoint is
        # limited as PX4's MPC_*_VEL_MAX
        kp = torch.tensor(g.pos_p, dtype=pos.dtype, device=pos.device)
        vel_sp = kp * (action[..., 0:3] - pos)
        vxy = vel_sp[..., :2]
        vxy_n = torch.linalg.norm(vxy, dim=-1, keepdim=True)
        vxy = vxy * torch.clamp_max(g.vel_max_xy / torch.clamp_min(vxy_n,
                                                                   1e-6),
                                    1.0)
        vz = torch.clamp(vel_sp[..., 2], -g.vel_max_dn, g.vel_max_up)
        vel_sp = torch.cat([vxy, vz[..., None]], dim=-1)
        quat_sp, thrust, cs = velocity_control(g, cs, vel, vel_sp,
                                               action[..., 3], dt)
        rate_sp = attitude_rates(g, quat, quat_sp)
        return rate_control(g, cs, quat, angvel, rate_sp, thrust, dt)

    raise ValueError(f"unknown control mode {mode!r}; expected "
                     f"{CONTROL_MODES}")


def num_actions(mode: str) -> int:
    """5 in atti (a quaternion and the thrust), else 4."""
    return 5 if mode == "atti" else 4


def action_limits(mode: str):
    """Default (lower, upper) action limits per mode; a task overrides a
    mode through ``QuadEnvCore.action_limit_overrides``."""
    if mode == "pos":
        return np.array([-3.0, -3, -3, -6]), np.array([3.0, 3, 3, 6])
    if mode == "vel":
        return np.array([-6.0] * 4), np.array([6.0] * 4)
    if mode == "atti":
        return np.array([-1, -1, -1, -1, 0.0]), np.array([1, 1, 1, 1, 1.0])
    if mode == "rate":
        return np.array([-6.0, -6, -6, 0]), np.array([6.0, 6, 6, 1])
    if mode == "prop":
        return np.array([0.0] * 4), np.array([1.0] * 4)
    raise ValueError(f"unknown control mode {mode!r}")
