"""Balloon task (counterpart of airgym_tpu/envs/balloon.py).

Dash forward and pop a randomly placed balloon: the obs is the 18-dim
state relative to the balloon (rotation-matrix and position differences);
+800 on a hit within 0.1 m; the reference's aggressive kill rules; ground
collision (base sphere of ``ROBOT_COLLISION_RADIUS`` touching z = 0)
resets. Episode 8 s; body rates limited to +-1 rad/s.

Draw order of ``step`` on the generator: obs noise, then the drone's
reset draws, then the balloon's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from airgym_tpu_torch import assets
from airgym_tpu_torch.envs import base
from airgym_tpu_torch.math import rotations as rot


@dataclasses.dataclass(frozen=True)
class BalloonCfg(base.BaseEnvCfg):
    num_envs: int = 64
    episode_length_s: float = 8.0


class BalloonState(NamedTuple):
    core: base.EnvState
    balloon: torch.Tensor          # [N, 13] balloon root states
    pre_root_pos: torch.Tensor     # [N, 3]


class Balloon(base.QuadEnvCore):
    task_name = "balloon"
    action_limit_overrides = {"rate": base.NARROW_RATE_LIMITS}
    num_obs = 18
    # the episode succeeds iff it ends by popping the balloon
    has_success = True

    def _uniform(self, generator, *shape):
        return self.rand(generator, *shape)

    def initial_state(self, generator: torch.Generator) -> BalloonState:
        n = self.cfg.num_envs
        root = self._reset_root(generator, n)
        balloon = self._reset_balloon(generator, n)
        return BalloonState(core=self.init_core(root), balloon=balloon,
                            pre_root_pos=torch.zeros((n, 3),
                                                     dtype=self.cfg.dtype,
                                                     device=self.device))

    def _reset_balloon(self, generator, n):
        u = lambda: self._uniform(generator, n) * 2.0 - 1.0
        x = 2.5 + 0.5 * u()
        y = 2.0 * u()
        z = 1.0 + 0.3 * u()
        s = torch.zeros((n, 13), dtype=self.cfg.dtype, device=self.device)
        s[:, 6] = 1.0
        s[:, 0:3] = torch.stack([x, y, z], dim=-1)
        return s

    def _reset_root(self, generator, n):
        """Tight xy, z ~ 1, a larger tilt to encourage exploration (pitch
        drawn one-sided positive)."""
        u = lambda *shape: self._uniform(generator, *shape) * 2.0 - 1.0
        xy = 0.1 * u(n, 2)
        z = 1.0 + 0.2 * u(n, 1)
        ang = torch.cat([0.1 * math.pi * u(n, 1),
                         0.1 * math.pi * self._uniform(generator, n, 1),
                         0.2 * math.pi * u(n, 1)], dim=-1)
        quat = rot.quat_from_euler_xyz(ang)
        v = 0.5 * u(n, 3)
        w = 0.2 * u(n, 3)
        return torch.cat([xy, z, quat, v, w], dim=-1)

    def step(self, state: BalloonState, actions: torch.Tensor,
             generator: Optional[torch.Generator]
             ) -> Tuple[BalloonState, base.StepOutput]:
        core = state.core
        acts = self.remap_actions(actions)
        cmds, ctrl = self.run_controller(core, acts)
        root, rotors = self.physics_step(core, cmds)
        progress = core.progress + 1

        obs = self._observations(root, state.balloon, generator)
        collisions = root[:, 2] < assets.ROBOT_COLLISION_RADIUS
        reward, die, info = self._reward(root, state.balloon, acts,
                                         core.pre_actions,
                                         state.pre_root_pos)
        max_len = self.cfg.max_episode_length
        die = die | collisions
        timeout = (progress >= max_len - 1) & ~die
        reset = die | (progress >= max_len - 1)

        core = core._replace(root=root, ctrl=ctrl, rotors=rotors,
                             progress=progress, pre_actions=acts)
        n = self.cfg.num_envs
        core = self.apply_reset(core, reset, self._reset_root(generator, n))
        m = reset[:, None]
        balloon = torch.where(m, self._reset_balloon(generator, n),
                              state.balloon)
        pre_pos = torch.where(m, torch.zeros((), dtype=root.dtype,
                                             device=root.device),
                              root[:, 0:3])
        out = base.StepOutput(obs=obs, priv_obs=balloon[:, None, :],
                              reward=reward, reset=reset, timeout=timeout,
                              info=info)
        return BalloonState(core=core, balloon=balloon,
                            pre_root_pos=pre_pos), out

    def _observations(self, root, balloon, generator):
        """(R - R_balloon, pos - pos_balloon, v, w), the noise added
        before the balloon is subtracted."""
        obs = self.state_obs18(root, generator)
        b_mat = rot.quat_to_matrix(balloon[:, 3:7]).reshape(-1, 9)
        return torch.cat([obs[:, 0:9] - b_mat, obs[:, 9:12] - balloon[:, 0:3],
                          obs[:, 12:]], dim=-1)

    def _reward(self, root, balloon, actions, pre_actions, pre_root_pos):
        pos, v = root[:, 0:3], root[:, 7:10]
        b_pos = balloon[:, 0:3]
        rel = b_pos - pos
        check = torch.linalg.norm(rel, dim=-1)

        direction = rel / torch.clamp_min(check[:, None], 1e-6)
        dir_yaw = torch.atan2(direction[:, 1], direction[:, 0])
        euler = rot.quat_to_euler_xyz(root[:, 3:7])
        rel_heading = rot.yaw_diff(euler[..., 2], dir_yaw)
        yaw_r = 1.0 / (1.0 + torch.square(1.6 * torch.abs(rel_heading)))

        guidance_r = 30.0 * (torch.linalg.norm(b_pos - pre_root_pos, dim=-1)
                             - check)
        ups = rot.quat_axis(root[:, 3:7], 2)[:, 2]
        ups_r = 0.5 * torch.square((ups + 1.0) / 2.0)
        hit = check < 0.1
        hit_r = 800.0 * hit.to(pos.dtype)
        effort_r = 0.1 * torch.exp(-torch.sum(torch.square(actions), dim=-1))
        smooth_r = 0.1 * torch.exp(
            -torch.linalg.norm(actions - pre_actions, dim=-1))
        reward = guidance_r + yaw_r + hit_r + smooth_r + ups_r + effort_r

        die = actions[..., -1] < -1.0
        die |= actions[..., -1] > 1.0
        die |= rel[..., 0] < -0.2          # balloon passed behind
        die |= v[..., 0] < 0.0             # flying backwards
        die |= check > 4.0
        die |= pos[..., 2] < 0.5
        die |= pos[..., 2] > 1.5
        die |= hit                         # a hit ends the episode
        info = {
            "guidance_reward": guidance_r,
            "hit_reward": hit_r,
            "action_smoothness_reward": smooth_r,
            "effort_reward": effort_r,
            "ups_reward": ups_r,
            "reward": reward,
            "success": hit,
        }
        return reward, die, info
