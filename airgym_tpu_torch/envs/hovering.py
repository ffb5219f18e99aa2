"""Hovering task (counterpart of airgym_tpu/envs/hovering.py).

Reach and hold the identity pose at the origin from randomized starts.
Obs is the 18-dim state vector relative to ``target_state``; termination:
dist > 4 m, |rel z| > 2 m, upside-down, or the 24 s episode length.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from airgym_tpu_torch.envs import base
from airgym_tpu_torch.math import rotations as rot


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

    def initial_state(self, generator: torch.Generator) -> HoveringState:
        root = self.randomize_hover_reset(generator, self.cfg.num_envs)
        return HoveringState(core=self.init_core(root))

    def step(self, state: HoveringState, actions: torch.Tensor,
             generator: Optional[torch.Generator]
             ) -> Tuple[HoveringState, base.StepOutput]:
        core = state.core
        acts = self.remap_actions(actions)
        cmds, ctrl = self.run_controller(core, acts)
        root, rotors = self.physics_step(core, cmds)
        progress = core.progress + 1

        obs = self.state_obs18(root, generator) - self.target
        reward, die, info = self._reward(root, acts, core.pre_actions, cmds)
        max_len = self.cfg.max_episode_length
        timeout = (progress >= max_len - 1) & ~die
        reset = die | (progress >= max_len - 1)

        core = core._replace(root=root, ctrl=ctrl, rotors=rotors,
                             progress=progress, pre_actions=acts)
        new_root = self.randomize_hover_reset(generator, self.cfg.num_envs)
        core = self.apply_reset(core, reset, new_root)
        out = base.StepOutput(obs=obs, priv_obs=None, reward=reward,
                              reset=reset, timeout=timeout, info=info)
        return HoveringState(core=core), out

    def _reward(self, root, actions, pre_actions, cmd_thrusts):
        mode = self.cfg.ctl_mode
        effort_r = base.effort_reward(cmd_thrusts)
        cont_r, thrust_r = base.continuity_rewards(mode, actions,
                                                   pre_actions)
        pos_r, vel_dir_r, rel = base.pos_reward_terms(root, self.target_pos)
        yaw_r, spin_r, ups_r, ups_z = base.attitude_reward_terms(
            root, self.target_yaw)
        shaped = pos_r * (vel_dir_r + ups_r + spin_r + yaw_r)
        if thrust_r is None:                      # pos, vel, prop
            reward = cont_r + effort_r + pos_r + shaped
            thrust_r = torch.zeros_like(effort_r)
        else:
            reward = cont_r + effort_r + thrust_r + pos_r + shaped
        die = torch.linalg.norm(rel, dim=-1) > 4.0
        die |= rel[..., 2] < -2.0
        die |= rel[..., 2] > 2.0
        die |= ups_z < 0.0
        if mode == "atti":
            die |= actions[..., 0] < 0.0          # commanded qw < 0
        info = {
            "continous_action_reward": cont_r,
            "effort_reward": effort_r,
            "thrust_reward": thrust_r,
            "pos_reward": pos_r,
            "vel_direction_reward": vel_dir_r,
            "ups_reward": ups_r,
            "spin_reward": spin_r,
            "yaw_reward": yaw_r,
            "reward": reward,
        }
        return reward, die, info
