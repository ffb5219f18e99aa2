"""Batched rotation math (counterpart of airgym_tpu/math/rotations.py).

Conventions are the reference's:
  * quaternions are stored xyzw (IsaacGym root-state layout);
  * helpers with ``wxyz`` in their name convert to and from the PX4 /
    pytorch3d layout;
  * Euler conversions use the XYZ intrinsic convention of
    ``pytorch3d.transforms.euler_angles_to_matrix(..., 'XYZ')``.

Every function takes tensors shaped ``[..., 3/4/9]``.
"""
from __future__ import annotations

import math

import torch


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b of xyzw quaternions."""
    x1, y1, z1, w1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    x2, y2, z2, w2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    x = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2
    y = w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2
    z = w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2
    w = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2
    return torch.stack([x, y, z, w], dim=-1)


def quat_normalize(q: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True),
                               eps)


def quat_canonical(q: torch.Tensor) -> torch.Tensor:
    """Flip the sign so that w >= 0."""
    return torch.where(q[..., 3:4] < 0.0, -q, q)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by q (body -> world)."""
    q_w = q[..., 3:4]
    q_vec = q[..., :3]
    a = v * (2.0 * q_w * q_w - 1.0)
    b = 2.0 * q_w * torch.linalg.cross(q_vec, v, dim=-1)
    c = 2.0 * q_vec * torch.sum(q_vec * v, dim=-1, keepdim=True)
    return a + b + c


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by the inverse of q (world -> body)."""
    return quat_rotate(quat_conjugate(q), v)


def quat_axis(q: torch.Tensor, axis: int) -> torch.Tensor:
    """Column ``axis`` of the rotation matrix."""
    basis = torch.zeros(q.shape[:-1] + (3,), dtype=q.dtype, device=q.device)
    basis[..., axis] = 1.0
    return quat_rotate(q, basis)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    q = quat_normalize(q)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> xyzw quaternion with w >= 0 (branch-free
    Shepperd: all four pivots, the largest wins)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    qw2 = 1.0 + m00 + m11 + m22
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp_min(v, 1e-12))

    w_w = 0.5 * safe_sqrt(qw2)
    q_w = torch.stack([(m21 - m12) / (4.0 * w_w), (m02 - m20) / (4.0 * w_w),
                       (m10 - m01) / (4.0 * w_w), w_w], dim=-1)
    x_x = 0.5 * safe_sqrt(qx2)
    q_x = torch.stack([x_x, (m01 + m10) / (4.0 * x_x),
                       (m02 + m20) / (4.0 * x_x),
                       (m21 - m12) / (4.0 * x_x)], dim=-1)
    y_y = 0.5 * safe_sqrt(qy2)
    q_y = torch.stack([(m01 + m10) / (4.0 * y_y), y_y,
                       (m12 + m21) / (4.0 * y_y),
                       (m02 - m20) / (4.0 * y_y)], dim=-1)
    z_z = 0.5 * safe_sqrt(qz2)
    q_z = torch.stack([(m02 + m20) / (4.0 * z_z), (m12 + m21) / (4.0 * z_z),
                       z_z, (m10 - m01) / (4.0 * z_z)], dim=-1)

    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1),
                        dim=-1)[..., None]
    q = torch.where(best == 0, q_w,
                    torch.where(best == 1, q_x,
                                torch.where(best == 2, q_y, q_z)))
    return quat_canonical(quat_normalize(q))


def euler_xyz_to_matrix(euler: torch.Tensor) -> torch.Tensor:
    """XYZ intrinsic Euler -> R = Rx @ Ry @ Rz (closed form)."""
    a, b, c = euler[..., 0], euler[..., 1], euler[..., 2]
    ca, cb, cc = torch.cos(a), torch.cos(b), torch.cos(c)
    sa, sb, sc = torch.sin(a), torch.sin(b), torch.sin(c)
    m = torch.stack([
        cb * cc, -cb * sc, sb,
        ca * sc + sa * sb * cc, ca * cc - sa * sb * sc, -sa * cb,
        sa * sc - ca * sb * cc, sa * cc + ca * sb * sc, ca * cb,
    ], dim=-1)
    return m.reshape(euler.shape[:-1] + (3, 3))


def quat_from_euler_xyz(euler: torch.Tensor) -> torch.Tensor:
    return matrix_to_quat(euler_xyz_to_matrix(euler))


def matrix_to_euler_xyz(m: torch.Tensor) -> torch.Tensor:
    sy = torch.clamp(m[..., 0, 2], -1.0, 1.0)
    b = torch.asin(sy)
    a = torch.atan2(-m[..., 1, 2], m[..., 2, 2])
    c = torch.atan2(-m[..., 0, 1], m[..., 0, 0])
    return torch.stack([a, b, c], dim=-1)


def quat_to_euler_xyz(q: torch.Tensor) -> torch.Tensor:
    return matrix_to_euler_xyz(quat_to_matrix(q))


def yaw_from_quat(q: torch.Tensor) -> torch.Tensor:
    """ZYX-style heading used by the flight controller (PX4)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def wrap_angle(a: torch.Tensor) -> torch.Tensor:
    """Wrap to [-pi, pi) (floored modulo, as jnp.mod)."""
    return torch.remainder(a + math.pi, 2.0 * math.pi) - math.pi


def yaw_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return wrap_angle(b - a)


def xyzw_to_wxyz(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., 3:4], q[..., :3]], dim=-1)


def wxyz_to_xyzw(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., 1:4], q[..., 0:1]], dim=-1)


def quat_integrate(q: torch.Tensor, omega_body: torch.Tensor,
                   dt) -> torch.Tensor:
    """q * exp(0.5 dt omega): exact exponential-map update."""
    half_angle = 0.5 * dt * torch.linalg.norm(omega_body, dim=-1,
                                              keepdim=True)
    sinc = torch.sinc(half_angle / math.pi)
    vec = 0.5 * dt * omega_body * sinc
    dq = torch.cat([vec, torch.cos(half_angle)], dim=-1)
    return quat_normalize(quat_mul(q, dq))
