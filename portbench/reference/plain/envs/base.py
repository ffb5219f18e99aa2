"""Functional env core, rate mode.

A task is a pure function ``step(state, actions, generator) -> (state',
StepOutput)`` over an ``EnvState`` of [N, ...] tensors. Randomness comes
from an explicit ``torch.Generator`` on the env's device, drawn in a fixed
order: observation noise first, then the reset draws.

Reset semantics match the reference:
  * termination is computed after physics; terminated envs are
    re-randomized at the END of the same step, and the returned obs is
    the pre-reset one;
  * the first step after a reset applies ZERO rotor thrust;
  * ``timeout`` is the actual truncation flag (episode-length reset
    without a failure), which the PPO value bootstrap reads.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from portbench.reference.plain.control import px4
from portbench.reference.plain.math import rotations as rot
from portbench.reference.plain.physics import quadrotor as qd


class StepOutput(NamedTuple):
    obs: Any                      # [N, obs] or a dict of them
    reward: torch.Tensor          # [N]
    reset: torch.Tensor           # [N] bool, done flags
    timeout: torch.Tensor         # [N] bool, episode-length truncation


class EnvState(NamedTuple):
    root: torch.Tensor           # [N,13] root states (IsaacGym layout)
    ctrl: px4.CascadeState       # controller integrators
    progress: torch.Tensor       # [N] int32 steps since reset
    pre_actions: torch.Tensor    # [N,A] previous remapped actions
    reset_buf: torch.Tensor      # [N] bool, reset at the end of last step
    rotors: torch.Tensor         # [N,4] rotor thrusts applied


@dataclasses.dataclass(frozen=True)
class BaseEnvCfg:
    num_envs: int = 256
    ctl_mode: str = "rate"
    episode_length_s: float = 24.0
    dt: float = 0.01
    obs_noise: bool = True
    dtype: Any = torch.float32
    num_actions: int = 4

    @property
    def max_episode_length(self) -> int:
        return int(self.episode_length_s / self.dt)

    @property
    def cam_every(self) -> int:
        """Steps between camera renders (1 for tasks without a camera)."""
        return 1


class QuadEnvCore:
    """Action remap, controller + physics stepping, state observations
    with sensor noise."""

    task_name = "base"
    # the rate-mode action limits (lower, upper), if not the default
    rate_limits: Optional[Tuple[Any, Any]] = None
    obs_is_dict = False

    def __init__(self, cfg: BaseEnvCfg, device: torch.device):
        if cfg.ctl_mode != "rate":
            raise ValueError(f"the reference flies rate mode only, got "
                             f"{cfg.ctl_mode!r}")
        self.cfg = cfg
        self.device = device
        self.params = qd.x152b_params(dt=cfg.dt)
        self.gains = px4.CascadeGains()
        lo, hi = (px4.RATE_LIMITS if self.rate_limits is None else
                  tuple(np.asarray(x, np.float64) for x in self.rate_limits))
        self._act_lo = torch.tensor(lo, dtype=cfg.dtype, device=device)
        self._act_hi = torch.tensor(hi, dtype=cfg.dtype, device=device)

    def rand(self, generator, *shape):
        """U[0, 1) draws."""
        return torch.rand(shape, generator=generator, dtype=self.cfg.dtype,
                          device=self.device)

    def randn(self, generator, *shape):
        """N(0, 1) draws."""
        return torch.randn(shape, generator=generator, dtype=self.cfg.dtype,
                           device=self.device)

    def remap_actions(self, actions: torch.Tensor) -> torch.Tensor:
        """[-1,1] policy actions -> controller units: the thrust channel
        0.5+0.5a, then the limits."""
        thrust = 0.5 + 0.5 * actions[..., -1:]
        actions = torch.cat([actions[..., :-1], thrust], dim=-1)
        return torch.minimum(torch.maximum(actions, self._act_lo),
                             self._act_hi)

    def run_controller(self, state: EnvState, actions: torch.Tensor):
        cmds, ctrl = px4.run_rate(self.gains, state.ctrl, state.root,
                                  actions, self.cfg.dt)
        cmds = torch.where(state.reset_buf[:, None],
                           torch.zeros((), dtype=cmds.dtype,
                                       device=cmds.device), cmds)
        return cmds, ctrl

    def physics_step(self, core: EnvState, cmds: torch.Tensor):
        """-> (root', rotors'): rotors' is the thrust applied (no motor
        lag)."""
        return qd.step(self.params, core.root, cmds), cmds

    def state_obs18(self, root: torch.Tensor,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
        """rot-matrix(9) + pos(3) + linvel(3) + angvel(3), plus per-channel
        sensor noise when ``cfg.obs_noise``."""
        n = root.shape[0]
        mat = rot.quat_to_matrix(root[:, 3:7]).reshape(n, 9)
        obs = torch.cat([mat, root[:, 0:3], root[:, 7:10], root[:, 10:13]],
                        dim=-1)
        if self.cfg.obs_noise:
            scale = torch.tensor([1e-3] * 9 + [5e-3] * 3 + [2e-2] * 3
                                 + [4e-1] * 3, dtype=obs.dtype,
                                 device=obs.device)
            obs = obs + scale * self.randn(generator, *obs.shape)
        return obs

    def apply_reset(self, state: EnvState, reset_mask: torch.Tensor,
                    new_root: torch.Tensor) -> EnvState:
        m = reset_mask[:, None]
        zero = torch.zeros((), dtype=state.root.dtype,
                           device=state.root.device)
        return state._replace(
            root=torch.where(m, new_root, state.root),
            ctrl=px4.reset_state(state.ctrl, reset_mask),
            progress=torch.where(reset_mask,
                                 torch.zeros_like(state.progress),
                                 state.progress),
            pre_actions=torch.where(m, zero, state.pre_actions),
            reset_buf=reset_mask,
            rotors=torch.where(m, zero, state.rotors))

    def init_core(self, root: torch.Tensor) -> EnvState:
        n, dt = self.cfg.num_envs, self.cfg.dtype
        return EnvState(
            root=root,
            ctrl=px4.init_state(n, dtype=dt, device=self.device),
            progress=torch.zeros((n,), dtype=torch.int32,
                                 device=self.device),
            pre_actions=torch.zeros((n, self.cfg.num_actions), dtype=dt,
                                    device=self.device),
            reset_buf=torch.ones((n,), dtype=torch.bool, device=self.device),
            rotors=torch.zeros((n, 4), dtype=dt, device=self.device))

