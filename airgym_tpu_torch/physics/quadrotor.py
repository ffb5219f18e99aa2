"""Batched 6-DoF quadrotor dynamics (counterpart of
airgym_tpu/physics/quadrotor.py).

Root-state layout [N, 13] = pos(3) quat_xyzw(4) linvel(3) angvel(3) with
world-frame velocities; semi-implicit Euler at dt = 0.01. X152b constants
from the reference URDF: base 0.585 kg + 4 x 0.004 kg props, base inertia
diag(0.04), rotor arms (+-0.05374, +-0.05374, 0.024); 9.59 N of thrust
and 0.2 N m of yaw reaction per unit command.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from airgym_tpu_torch.math import rotations as rot


class QuadrotorParams(NamedTuple):
    mass: float                 # total mass [kg]
    inertia_diag: tuple         # body-frame principal inertia [kg m^2]
    rotor_pos: tuple            # 4 x (x, y, z), body frame [m]
    rotor_spin: tuple           # +1 / -1 yaw reaction sign per rotor
    thrust_scale: float         # N per unit normalized command
    torque_scale: float         # N m of yaw reaction per unit command
    gravity: float              # [m/s^2], acts along -z
    dt: float                   # physics step [s]
    motor_tau: float            # first-order motor lag [s]; 0 = off


_L = 0.05374  # rotor arm half-spacing [m]


def x152b_params(dt: float = 0.01, motor_tau: float = 0.0) -> QuadrotorParams:
    base_m, prop_m = 0.585, 0.004
    mass = base_m + 4.0 * prop_m
    z = 0.024
    ixx = 0.04 + 4 * 1e-6 + 4 * prop_m * (_L * _L + z * z)
    iyy = ixx
    izz = 0.04 + 4 * 1e-6 + 4 * prop_m * (2 * _L * _L)
    rotor_pos = ((_L, -_L, z), (-_L, _L, z), (_L, _L, z), (-_L, -_L, z))
    rotor_spin = (-1.0, -1.0, 1.0, 1.0)
    return QuadrotorParams(mass=mass, inertia_diag=(ixx, iyy, izz),
                           rotor_pos=rotor_pos, rotor_spin=rotor_spin,
                           thrust_scale=9.59, torque_scale=0.2, gravity=9.81,
                           dt=dt, motor_tau=motor_tau)


def pack_state(pos, quat, linvel, angvel) -> torch.Tensor:
    return torch.cat([pos, quat, linvel, angvel], dim=-1)


def rotor_wrench(params: QuadrotorParams, cmd_thrusts: torch.Tensor):
    """Rotor commands [N,4] in [0,1] -> (force_body [N,3],
    torque_body [N,3])."""
    f = cmd_thrusts * params.thrust_scale
    rp = torch.tensor(params.rotor_pos, dtype=cmd_thrusts.dtype,
                      device=cmd_thrusts.device)
    spin = torch.tensor(params.rotor_spin, dtype=cmd_thrusts.dtype,
                        device=cmd_thrusts.device)
    fz = torch.sum(f, dim=-1)
    zero = torch.zeros_like(fz)
    force = torch.stack([zero, zero, fz], dim=-1)
    tx = torch.sum(f * rp[:, 1], dim=-1)
    ty = -torch.sum(f * rp[:, 0], dim=-1)
    tz = torch.sum(cmd_thrusts * spin, dim=-1) * params.torque_scale
    return force, torch.stack([tx, ty, tz], dim=-1)


def motor_alpha(params: QuadrotorParams) -> float:
    """exp(-dt/tau), the per-step decay of the rotor lag; 0 when off."""
    if params.motor_tau <= 0.0:
        return 0.0
    return float(math.exp(-params.dt / params.motor_tau))


def rotor_lag(params: QuadrotorParams, rotors: torch.Tensor,
              cmd_thrusts: torch.Tensor) -> torch.Tensor:
    """Actual rotor thrust tracks the command with time constant
    ``motor_tau`` (exact discrete form); identity when the lag is off."""
    if params.motor_tau <= 0.0:
        return cmd_thrusts
    alpha = motor_alpha(params)
    return alpha * rotors + (1.0 - alpha) * cmd_thrusts


def step(params: QuadrotorParams, state: torch.Tensor,
         cmd_thrusts: torch.Tensor,
         ext_force_world: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One semi-implicit Euler step of [N, 13] root states."""
    dt = params.dt
    pos, q, v, w_world = (state[..., 0:3], state[..., 3:7],
                          state[..., 7:10], state[..., 10:13])
    fb, tb = rotor_wrench(params, cmd_thrusts)
    f_world = rot.quat_rotate(q, fb)
    if ext_force_world is not None:
        f_world = f_world + ext_force_world
    g = torch.tensor([0.0, 0.0, -params.gravity], dtype=state.dtype,
                     device=state.device)
    v_new = v + dt * (f_world / params.mass + g)

    inertia = torch.tensor(params.inertia_diag, dtype=state.dtype,
                           device=state.device)
    w_body = rot.quat_rotate_inverse(q, w_world)
    gyro = torch.linalg.cross(w_body, inertia * w_body, dim=-1)
    w_body_new = w_body + dt * (tb - gyro) / inertia

    q_new = rot.quat_integrate(q, w_body_new, dt)
    pos_new = pos + dt * v_new
    w_world_new = rot.quat_rotate(q_new, w_body_new)
    return pack_state(pos_new, q_new, v_new, w_world_new)


def hover_command(params: QuadrotorParams) -> float:
    """Per-rotor command that cancels gravity (~0.1537 for the X152b)."""
    return params.mass * params.gravity / (4.0 * params.thrust_scale)
