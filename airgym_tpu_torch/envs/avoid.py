"""Avoid task helpers (counterpart of airgym_tpu/envs/avoid.py:61-83).

Only the local-frame state pieces that Planning shares with Avoid are
ported; the Avoid task itself is ROADMAP.md queue A item 12b.
"""
from __future__ import annotations

import torch

from airgym_tpu_torch.math import rotations as rot


def yaw_deroll_matrix(q_xyzw: torch.Tensor):
    """-> (world->local rotation Rz(yaw)^T [.., 3, 3], the attitude
    matrix [.., 3, 3]) (reference avoid.py:208-218)."""
    m = rot.quat_to_matrix(q_xyzw)
    yaw = torch.atan2(m[..., 1, 0], m[..., 0, 0])
    c, s = torch.cos(yaw), torch.sin(yaw)
    z = torch.zeros_like(yaw)
    o = torch.ones_like(yaw)
    w2l = torch.stack([c, s, z, -s, c, z, z, z, o],
                      dim=-1).reshape(q_xyzw.shape[:-1] + (3, 3))
    return w2l, m


def local_state_obs(root: torch.Tensor, target_pos,
                    actions: torch.Tensor) -> torch.Tensor:
    """16-dim local-frame state obs: position relative to the target,
    local euler angles, local linear and angular velocity, the actions."""
    w2l, m_global = yaw_deroll_matrix(root[:, 3:7])
    euler_local = rot.matrix_to_euler_xyz(w2l @ m_global)
    vel_local = torch.einsum("nij,nj->ni", w2l, root[:, 7:10])
    angvel_local = torch.einsum("nij,nj->ni", w2l, root[:, 10:13])
    rel = root[:, 0:3] - torch.as_tensor(target_pos, dtype=root.dtype,
                                         device=root.device)
    return torch.cat([rel, euler_local, vel_local, angvel_local, actions],
                     dim=-1)
