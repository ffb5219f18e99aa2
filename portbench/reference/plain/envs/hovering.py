"""Hovering task: reach and hold the identity pose at the origin from
randomized starts. Obs is the 18-dim state vector relative to the target;
termination: dist > 4 m, |rel z| > 2 m, upside-down, or the 24 s episode
length.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from portbench.reference.plain.envs import base
from portbench.reference.plain.math import rotations as rot


@dataclasses.dataclass(frozen=True)
class HoveringCfg(base.BaseEnvCfg):
    num_envs: int = 256
    episode_length_s: float = 24.0
    # identity rotation at the origin, zero velocities
    target_state: tuple = (1., 0., 0., 0., 1., 0., 0., 0., 1.,
                           0., 0., 0., 0., 0., 0., 0., 0., 0.)


class HoveringState(NamedTuple):
    core: base.EnvState


class Hovering(base.QuadEnvCore):
    task_name = "hovering"
    num_obs = 18

    def __init__(self, cfg: HoveringCfg, device: torch.device):
        super().__init__(cfg, device)
        self.target = torch.tensor(cfg.target_state, dtype=cfg.dtype,
                                   device=device)[None].repeat(
                                       cfg.num_envs, 1)
        tmat = self.target[:, 0:9].reshape(-1, 3, 3)
        self.target_yaw = rot.matrix_to_euler_xyz(tmat)[..., 2]
        self.target_pos = self.target[:, 9:12]

    def _reset_root(self, generator: torch.Generator) -> torch.Tensor:
        """pos ~ U(-1,1)^3, tilt 0.01 pi U, yaw 0.05 pi U, v ~ 0.5 U,
        w ~ 0.2 U."""
        n = self.cfg.num_envs
        u = lambda *shape: self.rand(generator, *shape) * 2.0 - 1.0
        pos = u(n, 3)
        ang = torch.cat([0.01 * math.pi * u(n, 2), 0.05 * math.pi * u(n, 1)],
                        dim=-1)
        quat = rot.quat_from_euler_xyz(ang)
        linvel = 0.5 * u(n, 3)
        angvel = 0.2 * u(n, 3)
        return torch.cat([pos, quat, linvel, angvel], dim=-1)

    def initial_state(self, generator: torch.Generator) -> HoveringState:
        return HoveringState(core=self.init_core(self._reset_root(generator)))

    def step(self, state: HoveringState, actions: torch.Tensor,
             generator: Optional[torch.Generator]
             ) -> Tuple[HoveringState, base.StepOutput]:
        core = state.core
        acts = self.remap_actions(actions)
        cmds, ctrl = self.run_controller(core, acts)
        root, rotors = self.physics_step(core, cmds)
        progress = core.progress + 1

        obs = self.state_obs18(root, generator) - self.target
        reward, die = self._reward(root, acts, core.pre_actions, cmds)
        max_len = self.cfg.max_episode_length
        timeout = (progress >= max_len - 1) & ~die
        reset = die | (progress >= max_len - 1)

        core = core._replace(root=root, ctrl=ctrl, rotors=rotors,
                             progress=progress, pre_actions=acts)
        core = self.apply_reset(core, reset, self._reset_root(generator))
        out = base.StepOutput(obs=obs, reward=reward, reset=reset,
                              timeout=timeout)
        return HoveringState(core=core), out

    def _reward(self, root, actions, pre_actions, cmd_thrusts):
        effort_r = 0.1 * torch.sum(
            1.0 - torch.clamp(cmd_thrusts, 0.0, 1.0), dim=-1) / 4.0
        diff = actions - pre_actions
        cont_r = (0.2 * torch.exp(-torch.linalg.norm(diff[..., :-1], dim=-1))
                  + 0.5 / (1.0 + torch.square(3.0 * diff[..., -1])))
        thrust_r = 0.1 * (1.0 - torch.abs(0.1533 - actions[..., -1]))

        rel = self.target_pos - root[:, 0:3]
        dist = torch.linalg.norm(rel, dim=-1)
        pos_r = 0.7 / (1.0 + torch.square(1.6 * dist))
        tar_dir = rel / torch.clamp_min(dist[:, None], 1e-6)
        v = root[:, 7:10]
        v_dir = v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True),
                                    1e-6)
        dot = torch.clamp(torch.sum(tar_dir * v_dir, dim=-1), -1.0, 1.0)
        vel_dir_r = 0.1 * torch.exp(-torch.abs(torch.acos(dot)) / math.pi)

        q = root[:, 3:7]
        euler = rot.quat_to_euler_xyz(q)
        ydiff = rot.yaw_diff(self.target_yaw, euler[..., 2]) / math.pi
        yaw_r = 1.0 / (1.0 + torch.square(3.0 * ydiff))
        spin_r = 1.0 / (1.0 + torch.square(3.0 * torch.square(root[:, 12])))
        ups = rot.quat_axis(q, 2)[:, 2]
        ups_r = torch.square((ups + 1.0) / 2.0)

        shaped = pos_r * (vel_dir_r + ups_r + spin_r + yaw_r)
        reward = cont_r + effort_r + thrust_r + pos_r + shaped
        die = dist > 4.0
        die |= rel[..., 2] < -2.0
        die |= rel[..., 2] > 2.0
        die |= ups < 0.0
        return reward, die


# this file's task and its config, as ``envs.make_task`` finds them
TASK, CFG = Hovering, HoveringCfg
