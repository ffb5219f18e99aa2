"""Tracking task (counterpart of airgym_tpu/envs/tracking.py).

Follow a lemniscate reference trajectory: obs 48 = the 18-dim state
(noised, not target-relative) + 10 future reference points at a 5-step
stride, relative to the drone. Reward: distance / yaw / spin / ups terms;
die when more than 1 m from the current reference point. Episode 36 s.

Draw order of ``step`` on the generator: obs noise, then the reset draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from airgym_tpu_torch.envs import base
from airgym_tpu_torch.math import rotations as rot


@dataclasses.dataclass(frozen=True)
class TrackingCfg(base.BaseEnvCfg):
    num_envs: int = 64
    episode_length_s: float = 36.0
    target_state: tuple = (1., 0., 0., 0., 1., 0., 0., 0., 1.,
                           0., 0., 0., 0., 0., 0., 0., 0., 0.)
    traj_n_steps: int = 10
    traj_step_size: int = 5
    traj_scale: float = 0.25


class TrackingState(NamedTuple):
    core: base.EnvState
    pre_root_pos: torch.Tensor     # [N, 3]


class Tracking(base.QuadEnvCore):
    task_name = "tracking"
    action_limit_overrides = {
        "pos": ((-6.0, -6.0, -6.0, -6.0), (6.0, 6.0, 6.0, 6.0))}
    num_obs = 48

    def __init__(self, cfg: TrackingCfg, device: torch.device):
        super().__init__(cfg, device)
        t = torch.tensor(cfg.target_state, dtype=cfg.dtype, device=device)
        yaw = rot.matrix_to_euler_xyz(t[0:9].reshape(3, 3))[2]
        self.target_yaw = yaw.expand(cfg.num_envs).clone()

    def initial_state(self, generator: torch.Generator) -> TrackingState:
        n = self.cfg.num_envs
        return TrackingState(
            core=self.init_core(self._reset_root(generator, n)),
            pre_root_pos=torch.zeros((n, 3), dtype=self.cfg.dtype,
                                     device=self.device))

    def _reset_root(self, generator, n):
        """xy ~ +-0.1, z ~ 1 +- 0.1, tilt 0.1 pi, yaw 0.2 pi."""
        u = lambda *shape: self.rand(generator, *shape) * 2.0 - 1.0
        xy = 0.1 * u(n, 2)
        z = 1.0 + 0.1 * u(n, 1)
        ang = torch.cat([0.1 * math.pi * u(n, 2), 0.2 * math.pi * u(n, 1)],
                        dim=-1)
        quat = rot.quat_from_euler_xyz(ang)
        v = 0.5 * u(n, 3)
        w = 0.2 * u(n, 3)
        return torch.cat([xy, z, quat, v, w], dim=-1)

    def ref_trajectory(self, progress: torch.Tensor) -> torch.Tensor:
        """Figure-eight, ``traj_n_steps`` future points -> [N, n, 3]."""
        cfg = self.cfg
        steps = (progress[:, None]
                 + torch.arange(cfg.traj_n_steps, device=progress.device)
                 * cfg.traj_step_size)
        t = steps.to(cfg.dtype) * cfg.dt * cfg.traj_scale
        den = 1.0 + torch.square(torch.cos(t))
        x = 3.0 * torch.sin(t) / den
        y = 3.0 * torch.sin(t) * torch.cos(t) / den
        return torch.stack([x, y, torch.ones_like(x)], dim=-1)

    def observations(self, root, progress, generator):
        """obs18 (noised) + the reference window relative to the drone."""
        ref = self.ref_trajectory(progress)
        rel = (ref - root[:, None, 0:3]).reshape(root.shape[0], -1)
        return torch.cat([self.state_obs18(root, generator), rel], dim=-1), ref

    def step(self, state: TrackingState, actions: torch.Tensor,
             generator: Optional[torch.Generator]
             ) -> Tuple[TrackingState, base.StepOutput]:
        core = state.core
        acts = self.remap_actions(actions)
        cmds, ctrl = self.run_controller(core, acts)
        root, rotors = self.physics_step(core, cmds)
        progress = core.progress + 1

        obs, ref = self.observations(root, progress, generator)
        reward, die, info = self._reward(root, ref[:, 0], acts,
                                         core.pre_actions, cmds)
        max_len = self.cfg.max_episode_length
        timeout = (progress >= max_len - 1) & ~die
        reset = die | (progress >= max_len - 1)

        core = core._replace(root=root, ctrl=ctrl, rotors=rotors,
                             progress=progress, pre_actions=acts)
        core = self.apply_reset(core, reset,
                                self._reset_root(generator,
                                                 self.cfg.num_envs))
        pre_pos = torch.where(reset[:, None],
                              torch.zeros((), dtype=root.dtype,
                                          device=root.device),
                              root[:, 0:3])
        out = base.StepOutput(obs=obs, priv_obs=None, reward=reward,
                              reset=reset, timeout=timeout, info=info)
        return TrackingState(core=core, pre_root_pos=pre_pos), out

    def _reward(self, root, ref_now, actions, pre_actions, cmd_thrusts):
        """Hovering's terms against the moving reference, with the gains
        1.8 / 4 / 2 and other continuity weights."""
        mode = self.cfg.ctl_mode
        effort_r = base.effort_reward(cmd_thrusts)
        diff = actions - pre_actions
        if mode in ("pos", "vel", "prop"):
            cont_r = 0.2 * torch.exp(-torch.linalg.norm(diff, dim=-1))
            thrust_r = None
        else:
            cont_r = (0.1 * torch.exp(-torch.linalg.norm(diff[..., :-1],
                                                         dim=-1))
                      + 0.5 / (1.0 + torch.square(2.0 * diff[..., -1])))
            thrust_r = 0.1 * (1.0 - torch.abs(0.1533 - actions[..., -1]))

        dist = torch.linalg.norm(ref_now - root[:, 0:3], dim=-1)
        dist_r = 1.0 / (1.0 + torch.square(1.8 * dist))
        euler = rot.quat_to_euler_xyz(root[:, 3:7])
        ydiff = rot.yaw_diff(self.target_yaw, euler[..., 2]) / math.pi
        yaw_r = 1.0 / (1.0 + torch.square(4.0 * ydiff))
        spin = torch.square(root[:, 12])
        spin_r = 1.0 / (1.0 + torch.square(2.0 * spin))
        ups = rot.quat_axis(root[:, 3:7], 2)[:, 2]
        ups_r = torch.square((ups + 1.0) / 2.0)

        shaped = dist_r * (spin_r + yaw_r + ups_r)
        if thrust_r is None:
            reward = cont_r + effort_r + dist_r + shaped
            thrust_r = torch.zeros_like(dist)
        else:
            reward = cont_r + effort_r + thrust_r + dist_r + shaped
        die = dist > 1.0
        if mode == "atti":
            die |= actions[..., 0] < 0.0          # commanded qw < 0
        info = {
            "dist_norm": dist,
            "dist_reward": dist_r,
            "yaw_reward": yaw_r,
            "spin_reward": spin_r,
            "continous_action_reward": cont_r,
            "thrust_reward": thrust_r,
            "effort_reward": effort_r,
            "ups_reward": ups_r,
            "reward": reward,
        }
        return reward, die, info
