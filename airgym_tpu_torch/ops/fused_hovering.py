"""Pieces shared by the fused rollout kernels (counterpart of
airgym_tpu/ops/fused_hovering.py; its env-only ``_kernel`` is ROADMAP.md
queue B item 1 and is not ported yet).

Packed state record (field-major [40, N] float32):
  0:13  root state (IsaacGym layout)   13:16 rate integrator
  16:19 prev body rate                 19 progress   20 reset flag
  21:25 pre_actions (remapped)         25:29 rotor state (motor lag)
  29:35 task extras (balloon)          35:40 pad

The hash RNG below is the plain version of ``csrc/common.cuh``'s: uint32
arithmetic carried in int64 and masked to 32 bits, so that the bits equal
the Pallas kernels' and the CUDA kernels' exactly.
"""
from __future__ import annotations

import torch

from airgym_tpu_torch.control import px4
from airgym_tpu_torch.physics import quadrotor as qd

TILE = 1024                    # envs per Pallas grid cell: the RNG's tile
_F = 40                        # fields in the packed record

_P = qd.x152b_params()
_G = px4.CascadeGains()
_DT = 0.01
_HOVER_MAX_LEN = 2400          # 24 s / 0.01

_M32 = 0xFFFFFFFF


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


def _mulmod(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32) without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(x):
    """murmur3-style 32-bit finalizer on int64 values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mulmod(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mulmod(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _make_uniform(base_key, lanes: torch.Tensor):
    """Counter-based uniform draws in [0, 1): ``base_key`` is an int or an
    int64 tensor broadcastable to ``lanes`` (the env index in its
    1024-env tile). Each call advances the draw counter, starting at 1."""
    counter = [0]
    key_part = _mulmod(base_key, 0x9E3779B9)
    lane_part = (lanes + 0x85EBCA6B) & _M32

    def uniform():
        counter[0] += 1
        bits = _mix(key_part ^ lane_part
                    ^ _mulmod(counter[0], 0xC2B2AE35))
        return (bits >> 1).to(torch.float32) * (1.0 / 2147483648.0)

    return uniform


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
