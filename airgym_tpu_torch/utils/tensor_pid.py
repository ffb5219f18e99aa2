"""Batched PID controller (counterpart of airgym_tpu/utils/tensor_pid.py;
reference airgym/utils/tensor_pid.py:4-46) on tensors: integral,
derivative and output clamps, and a per-env reset by mask. Functional:
``step`` and ``reset`` return a new ``PIDState``."""
from __future__ import annotations

from typing import NamedTuple

import torch


class PIDState(NamedTuple):
    integral: torch.Tensor
    prev_error: torch.Tensor


class TensorPID(NamedTuple):
    kp: float
    ki: float
    kd: float
    integral_lim: float
    derivative_lim: float
    output_lim: float

    def init(self, shape, dtype=torch.float32, device=None) -> PIDState:
        z = torch.zeros(shape, dtype=dtype, device=device)
        return PIDState(integral=z, prev_error=z.clone())

    def step(self, st: PIDState, error: torch.Tensor, dt: float):
        integral = torch.clamp(st.integral + error * dt,
                               -self.integral_lim, self.integral_lim)
        deriv = torch.clamp((error - st.prev_error) / dt,
                            -self.derivative_lim, self.derivative_lim)
        out = torch.clamp(self.kp * error + self.ki * integral
                          + self.kd * deriv,
                          -self.output_lim, self.output_lim)
        return out, PIDState(integral=integral, prev_error=error)

    def reset(self, st: PIDState, mask: torch.Tensor) -> PIDState:
        m = mask.reshape(mask.shape + (1,) * (st.integral.dim() - mask.dim()))
        zero = torch.zeros((), dtype=st.integral.dtype,
                           device=st.integral.device)
        return PIDState(integral=torch.where(m, zero, st.integral),
                        prev_error=torch.where(m, zero, st.prev_error))
