"""Polynomial atan / atan2 / asin / acos (counterpart of
airgym_tpu/ops/transcendental.py).

The fused kernels use these polynomials instead of the native functions,
so the kernels' plain versions use them too. ``csrc/common.cuh`` holds
the same polynomials as device functions. Accuracy ~1e-6 absolute in f32.

atan core: 11th-order odd minimax polynomial on [-1, 1] with the range
reduction atan(x) = sign(x)*pi/2 - atan(1/x) for |x| > 1.
"""
from __future__ import annotations

import math

import torch

_PI = float(math.pi)
_HALF_PI = float(math.pi / 2)

_C1 = 0.99997726
_C3 = -0.33262347
_C5 = 0.19354346
_C7 = -0.11643287
_C9 = 0.05265332
_C11 = -0.01172120


def atan(x: torch.Tensor) -> torch.Tensor:
    ax = torch.abs(x)
    inv = ax > 1.0
    z = torch.where(inv, 1.0 / torch.clamp_min(ax, 1e-30), ax)
    z2 = z * z
    p = z * (_C1 + z2 * (_C3 + z2 * (_C5 + z2 * (_C7 + z2 * (
        _C9 + z2 * _C11)))))
    r = torch.where(inv, _HALF_PI - p, p)
    return torch.sign(x) * r


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Quadrant-correct atan2 (atan2(0, -1) = pi, as numpy)."""
    tiny = torch.abs(x) < 1e-30
    safe_x = torch.where(tiny, torch.full_like(x, 1e-30), x)
    base = atan(y / safe_x)
    shift = torch.where(y < 0.0, torch.full_like(y, -_PI),
                        torch.full_like(y, _PI))
    r = torch.where(x < 0.0, base + shift, base)
    half = torch.where(y >= 0.0, torch.full_like(y, _HALF_PI),
                       torch.full_like(y, -_HALF_PI))
    return torch.where(tiny, half, r)


def asin(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, -1.0, 1.0)
    return atan2(x, torch.sqrt(torch.clamp_min(1.0 - x * x, 0.0)))


def acos(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, -1.0, 1.0)
    return atan2(torch.sqrt(torch.clamp_min(1.0 - x * x, 0.0)), x)
