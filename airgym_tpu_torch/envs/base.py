"""Functional env framework (counterpart of airgym_tpu/envs/base.py).

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

Camera tasks (``obs_is_dict``) return ``{"image", "observation"}`` and
render every ``cfg.cam_every`` steps off a step counter. Their ``step``
takes a static ``render`` argument: None renders on the counter's
cadence, True renders now and False keeps the last image; the PPO
rollout passes True / False once ``PPO.init`` has aligned the counter to
the rollout's blocks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from airgym_tpu_torch.control import px4
from airgym_tpu_torch.math import rotations as rot
from airgym_tpu_torch.physics import quadrotor as qd


class StepOutput(NamedTuple):
    obs: torch.Tensor             # [N, obs]
    priv_obs: Any                 # env-asset root states or None
    reward: torch.Tensor          # [N]
    reset: torch.Tensor           # [N] bool, done flags
    timeout: torch.Tensor         # [N] bool, episode-length truncation
    info: Dict[str, torch.Tensor]  # reward terms, each [N]


class EnvState(NamedTuple):
    root: torch.Tensor           # [N,13] root states (IsaacGym layout)
    ctrl: px4.CascadeState       # controller integrators
    progress: torch.Tensor       # [N] int32 steps since reset
    pre_actions: torch.Tensor    # [N,A] previous remapped actions
    reset_buf: torch.Tensor      # [N] bool, reset at the end of last step
    rotors: torch.Tensor = None  # [N,4] actual rotor thrusts (motor lag)


@dataclasses.dataclass(frozen=True)
class BaseEnvCfg:
    num_envs: int = 256
    ctl_mode: str = "rate"
    episode_length_s: float = 24.0
    dt: float = 0.01
    obs_noise: bool = True
    motor_tau: float = 0.0
    dtype: Any = torch.float32

    @property
    def max_episode_length(self) -> int:
        return int(self.episode_length_s / self.dt)

    @property
    def num_actions(self) -> int:
        return px4.num_actions(self.ctl_mode)

    @property
    def cam_every(self) -> int:
        """Steps between camera renders (1 for tasks without a camera)."""
        return 1


# Narrowed rate limits of the vision-task lineage (reference
# customized.py:109-114: body rates +-1 rad/s instead of hovering's +-6).
NARROW_RATE_LIMITS = ((-1.0, -1.0, -1.0, 0.0), (1.0, 1.0, 1.0, 1.0))


class QuadEnvCore:
    """Action remap, controller + physics stepping, state observations
    with sensor noise, and the common reset randomization."""

    task_name = "base"
    # per-task action limits, keyed by ctl_mode -> (lower, upper); a mode
    # not listed takes the controller library's default
    action_limit_overrides: Dict[str, Tuple[Any, Any]] = {}
    # True for tasks whose step info carries a per-step "success" flag
    has_success = False
    # True for camera tasks: obs = {"image": [N,1,W,H], "observation"}
    obs_is_dict = False

    def __init__(self, cfg: BaseEnvCfg, device: torch.device):
        self.cfg = cfg
        self.device = device
        self.params = qd.x152b_params(dt=cfg.dt, motor_tau=cfg.motor_tau)
        self.gains = px4.CascadeGains()
        lo, hi = self.action_limits(cfg.ctl_mode)
        self._act_lo = torch.tensor(lo, dtype=cfg.dtype, device=device)
        self._act_hi = torch.tensor(hi, dtype=cfg.dtype, device=device)

    def action_limits(self, mode: str):
        """(lower, upper) for this task: the per-mode default unless the
        task overrides that mode."""
        ov = self.action_limit_overrides.get(mode)
        if ov is not None:
            return np.asarray(ov[0], np.float64), np.asarray(ov[1], np.float64)
        return px4.action_limits(mode)

    def remap_actions(self, actions: torch.Tensor) -> torch.Tensor:
        """[-1,1] policy actions -> controller units: the thrust channel
        0.5+0.5a in rate and atti only, then the per-mode limits."""
        if self.cfg.ctl_mode in ("rate", "atti"):
            thrust = 0.5 + 0.5 * actions[..., -1:]
            actions = torch.cat([actions[..., :-1], thrust], dim=-1)
        return torch.minimum(torch.maximum(actions, self._act_lo),
                             self._act_hi)

    def run_controller(self, state: EnvState, actions: torch.Tensor):
        cmds, ctrl = px4.run(self.cfg.ctl_mode, self.gains, state.ctrl,
                             state.root, actions, self.cfg.dt)
        cmds = torch.where(state.reset_buf[:, None],
                           torch.zeros((), dtype=cmds.dtype,
                                       device=cmds.device), cmds)
        return cmds, ctrl

    def physics_step(self, core: EnvState, cmds: torch.Tensor):
        """-> (root', rotors'): rotors' is the thrust actually applied."""
        if self.params.motor_tau > 0.0:
            rotors = qd.rotor_lag(self.params, core.rotors, cmds)
            return qd.step(self.params, core.root, rotors), rotors
        rotors = cmds if core.rotors is not None else None
        return qd.step(self.params, core.root, cmds), rotors

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
            obs = obs + scale * torch.randn(obs.shape, generator=generator,
                                            dtype=obs.dtype,
                                            device=obs.device)
        return obs

    def randomize_hover_reset(self, generator: torch.Generator,
                              n: int) -> torch.Tensor:
        """pos ~ U(-1,1)^3, tilt 0.01 pi U, yaw 0.05 pi U, v ~ 0.5 U,
        w ~ 0.2 U."""
        kw = dict(generator=generator, dtype=self.cfg.dtype,
                  device=self.device)
        u = lambda *shape: torch.rand(shape, **kw) * 2.0 - 1.0
        pos = u(n, 3)
        ang = torch.cat([0.01 * math.pi * u(n, 2), 0.05 * math.pi * u(n, 1)],
                        dim=-1)
        quat = rot.quat_from_euler_xyz(ang)
        linvel = 0.5 * u(n, 3)
        angvel = 0.2 * u(n, 3)
        return qd.pack_state(pos, quat, linvel, angvel)

    def apply_reset(self, state: EnvState, reset_mask: torch.Tensor,
                    new_root: torch.Tensor) -> EnvState:
        m = reset_mask[:, None]
        zero = torch.zeros((), dtype=state.root.dtype,
                           device=state.root.device)
        root = torch.where(m, new_root, state.root)
        return state._replace(
            root=root,
            ctrl=px4.reset_state(state.ctrl, reset_mask, root[:, 3:7]),
            progress=torch.where(reset_mask,
                                 torch.zeros_like(state.progress),
                                 state.progress),
            pre_actions=torch.where(m, zero, state.pre_actions),
            reset_buf=reset_mask,
            rotors=(None if state.rotors is None
                    else torch.where(m, zero, state.rotors)))

    def init_core(self, root: Optional[torch.Tensor] = None) -> EnvState:
        n, dt = self.cfg.num_envs, self.cfg.dtype
        if root is None:
            root = torch.zeros((n, 13), dtype=dt, device=self.device)
            root[:, 6] = 1.0
        return EnvState(
            root=root,
            ctrl=px4.init_state(n, dtype=dt, device=self.device),
            progress=torch.zeros((n,), dtype=torch.int32,
                                 device=self.device),
            pre_actions=torch.zeros((n, self.cfg.num_actions), dtype=dt,
                                    device=self.device),
            reset_buf=torch.ones((n,), dtype=torch.bool, device=self.device),
            rotors=torch.zeros((n, 4), dtype=dt, device=self.device))


# ---------------------------------------------------------------------------
# reward pieces shared by tasks


def effort_reward(cmd_thrusts: torch.Tensor) -> torch.Tensor:
    t = torch.clamp(cmd_thrusts, 0.0, 1.0)
    return 0.1 * torch.sum(1.0 - t, dim=-1) / 4.0


def continuity_rewards(ctl_mode: str, actions, pre_actions):
    """-> (continuity_reward, thrust_reward or None)."""
    diff = actions - pre_actions
    if ctl_mode in ("pos", "vel", "prop"):
        return 0.2 * torch.exp(-torch.linalg.norm(diff, dim=-1)), None
    cont = (0.2 * torch.exp(-torch.linalg.norm(diff[..., :-1], dim=-1))
            + 0.5 / (1.0 + torch.square(3.0 * diff[..., -1])))
    thrust = actions[..., -1]
    return cont, 0.1 * (1.0 - torch.abs(0.1533 - thrust))


def pos_reward_terms(root: torch.Tensor, target_pos: torch.Tensor):
    """-> (pos_reward, vel_direction_reward, relative_positions)."""
    rel = target_pos - root[:, 0:3]
    dist = torch.linalg.norm(rel, dim=-1)
    pos_r = 0.7 / (1.0 + torch.square(1.6 * dist))
    tar_dir = rel / torch.clamp_min(dist[:, None], 1e-6)
    v = root[:, 7:10]
    v_dir = v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True),
                                1e-6)
    dot = torch.clamp(torch.sum(tar_dir * v_dir, dim=-1), -1.0, 1.0)
    angle = torch.abs(torch.acos(dot))
    return pos_r, 0.1 * torch.exp(-angle / math.pi), rel


def attitude_reward_terms(root: torch.Tensor, target_yaw: torch.Tensor):
    """-> (yaw_reward, spin_reward, ups_reward, ups_z)."""
    q = root[:, 3:7]
    euler = rot.quat_to_euler_xyz(q)
    ydiff = rot.yaw_diff(target_yaw, euler[..., 2]) / math.pi
    yaw_r = 1.0 / (1.0 + torch.square(3.0 * ydiff))
    spin = torch.square(root[:, 12])
    spin_r = 1.0 / (1.0 + torch.square(3.0 * spin))
    ups = rot.quat_axis(q, 2)[:, 2]
    ups_r = torch.square((ups + 1.0) / 2.0)
    return yaw_r, spin_r, ups_r, ups


# --------------------------------------------------------------------------
# stateful wrapper with the reference env API


class TaskWrapper:
    """Reference-compatible stateful facade over a functional task.

    ``step(actions)`` returns (obs, priv_obs, rew, reset, extras) with
    extras = {'time_outs', 'item_reward_info'}, as the reference's tasks
    do; ``reset()`` re-draws every env from the wrapper's generator (the
    state's own RNG) and takes a zero-action step. Rows are the task's
    actors: ``num_envs``, or ``num_envs * num_robots`` for a task that
    flattens its robot axis (MAPlanning's ``flat_n``)."""

    def __init__(self, task, seed: int = 0):
        self.task = task
        self.cfg = task.cfg
        self.device = task.device
        self.num_envs = task.cfg.num_envs
        self.num_rows = getattr(task, "flat_n", task.cfg.num_envs)
        self.num_actions = task.cfg.num_actions
        self.num_obs = task.num_obs
        self.generator = torch.Generator(device=task.device)
        self.generator.manual_seed(seed)
        self.state = task.initial_state(self.generator)

    def step(self, actions):
        actions = torch.as_tensor(actions, dtype=self.cfg.dtype,
                                  device=self.device)
        self.state, out = self.task.step(self.state, actions, self.generator)
        extras = {"time_outs": out.timeout, "item_reward_info": out.info}
        return out.obs, out.priv_obs, out.reward, out.reset, extras

    def reset(self):
        self.state = self.task.initial_state(self.generator)
        zero = torch.zeros((self.num_rows, self.num_actions),
                           dtype=self.cfg.dtype, device=self.device)
        obs, priv, _, _, _ = self.step(zero)
        return obs, priv
