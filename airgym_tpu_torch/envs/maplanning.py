"""MAPlanning task (counterpart of airgym_tpu/envs/maplanning.py).

Multi-agent corridor flight: R robots per env (4 by default) race to one
shared goal ball. Every robot has its own depth camera, in which the
other robots of its env are 0.2 m spheres beside the goal ball (itself
too: it sits behind its own camera and is never hit). The observation is
[goal_dir_local(3), euler_local(3), vel_local(3), angvel_local(3),
actions(4), 2R relative-robot channels], and the reference computes
those last channels and then zeroes them; so they are zeros here.

Outputs are flattened env-major over the robots, [E * R, ...] with row
e * R + r for robot r of env e, so the single-agent PPO trains the robots
as E * R actors (``flat_n``). ``progress`` is per env [E]; every other
field of the core state is per robot. The image is the clean clamped and
normalised depth, no noise and no blur: the raw depth kernel
(render/depth.render_depth_auto, csrc/render_depth.cu), then clamp /
normalise in PyTorch.

Rewards follow the Planning terms; a robot is done when it flies too
high, touches the ground or reaches the goal, and its whole env resets
when any robot is done or the episode times out. ``StepOutput.reset`` is
the per-robot done flag, as in the reference, while
``info["env_success"]`` / ``info["env_done"]`` report the env-level
episode (any robot reached the goal; the env reset) on each of its rows.
``priv_obs`` is the goal ball's root state [E, 1, 13].

Draw order of ``step`` on the generator: the goal offsets [E], then the
robots' start y [E, R] of the env reset (drawn for every env, used where
an env resets).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from airgym_tpu_torch import assets
from airgym_tpu_torch.control import px4
from airgym_tpu_torch.envs import base
from airgym_tpu_torch.envs.avoid import yaw_deroll_matrix
from airgym_tpu_torch.math import rotations as rot
from airgym_tpu_torch.physics import scene as sc
from airgym_tpu_torch.render import depth as dr

LENGTH = 8.0
WIDTH = 4.0
FLY_HEIGHT = 1.5


@dataclasses.dataclass(frozen=True)
class MAPlanningCfg(base.BaseEnvCfg):
    num_envs: int = 4
    episode_length_s: float = 16.0
    create_ground_plane: bool = True
    cam_dt: float = 0.04
    cam_width: int = 212
    cam_height: int = 120
    num_robots: int = 4
    # curriculum knob: every robot starts at this x instead of
    # -LENGTH - 0.5 (None = reference)
    start_x: Optional[float] = None

    @property
    def cam_every(self) -> int:
        return int(round(self.cam_dt / self.dt))

    @property
    def num_agents(self) -> int:
        return self.num_robots


class MAPlanningState(NamedTuple):
    core: base.EnvState           # per robot [E * R, ...], progress [E]
    goal: torch.Tensor            # [E, 3] shared goal per env
    camera: torch.Tensor          # [E * R, 1, W, H]
    esdf: torch.Tensor            # [E * R] min of the camera image
    counter: int                  # steps since the start (camera cadence)
    pre_root_pos: torch.Tensor    # [E * R, 3]


class MAPlanning(base.QuadEnvCore):
    task_name = "maplanning"
    action_limit_overrides = {"rate": base.NARROW_RATE_LIMITS}
    obs_is_dict = True
    # info["success"]: a robot reached the goal (per robot)
    has_success = True
    # info["env_success"] / ["env_done"]: the env-level episode; per-robot
    # success is capped near 1 / R, since the whole env resets on any
    # robot's event, so the best-success checkpoint gates on this rate
    has_env_success = True

    def __init__(self, cfg: MAPlanningCfg, device: torch.device):
        super().__init__(cfg, device)
        self.cam_cfg = dr.CameraCfg(width=cfg.cam_width,
                                    height=cfg.cam_height)
        self.num_obs = 16 + 2 * cfg.num_robots
        self.flat_n = cfg.num_envs * cfg.num_robots
        self.obs_spec = {
            "image": (self.flat_n, 1, cfg.cam_width, cfg.cam_height),
            "observation": (self.flat_n, self.num_obs),
        }

    @property
    def num_actors_flat(self) -> int:
        return self.flat_n

    def _uniform(self, generator, *shape):
        return self.rand(generator, *shape)

    # -- resets -----------------------------------------------------------

    def _reset_goal(self, generator, e):
        gy = 1.5 * (self._uniform(generator, e) * 2.0 - 1.0)
        return torch.stack([torch.full_like(gy, LENGTH + 0.5), gy,
                            torch.full_like(gy, FLY_HEIGHT)], dim=-1)

    def _reset_root(self, generator, goal, e):
        """Every robot at x = -L - 0.5, y ~ +-2, z = FLY_HEIGHT, yawed at
        the goal, at rest (reference maplanning.py:226-257)."""
        r = self.cfg.num_robots
        y = 2.0 * (self._uniform(generator, e, r) * 2.0 - 1.0)
        x0 = (-LENGTH - 0.5 if self.cfg.start_x is None
              else float(self.cfg.start_x))
        x = torch.full_like(y, x0)
        z = torch.full_like(y, FLY_HEIGHT)
        yaw = torch.atan2(goal[:, None, 1] - y, goal[:, None, 0] - x)
        zeros = torch.zeros_like(yaw)
        quat = rot.quat_from_euler_xyz(torch.stack([zeros, zeros, yaw],
                                                   dim=-1))
        root = torch.cat([torch.stack([x, y, z], dim=-1), quat,
                          torch.zeros((e, r, 6), dtype=quat.dtype,
                                      device=self.device)], dim=-1)
        return root.reshape(e * r, 13).to(self.cfg.dtype)

    def initial_state(self, generator: torch.Generator) -> MAPlanningState:
        cfg = self.cfg
        e, n, dt = cfg.num_envs, self.flat_n, cfg.dtype
        goal = self._reset_goal(generator, e)
        root = self._reset_root(generator, goal, e)
        kw = dict(dtype=dt, device=self.device)
        core = base.EnvState(
            root=root,
            ctrl=px4.init_state(n, dtype=dt, device=self.device),
            progress=torch.zeros((e,), dtype=torch.int32, device=self.device),
            pre_actions=torch.zeros((n, cfg.num_actions), **kw),
            reset_buf=torch.ones((n,), dtype=torch.bool, device=self.device),
            rotors=torch.zeros((n, 4), **kw))
        return MAPlanningState(
            core=core, goal=goal,
            camera=torch.zeros((n, 1, cfg.cam_width, cfg.cam_height), **kw),
            esdf=torch.full((n,), 10.0, **kw), counter=0,
            pre_root_pos=torch.zeros((n, 3), **kw))

    # -- scene: each robot sees the goal ball and the robots of its env ----

    def scene(self, root: torch.Tensor,
              goal: torch.Tensor) -> dr.SceneForRender:
        """Per flat robot: R + 1 spheres (the robots of its env, itself
        included, then the goal) and the ground."""
        e, r = self.cfg.num_envs, self.cfg.num_robots
        n = self.flat_n
        pos_er = root[:, 0:3].reshape(e, r, 3)
        robots = pos_er[:, None, :, :].expand(e, r, r, 3).reshape(n, r, 3)
        goals = goal[:, None, None, :].expand(e, r, 1, 3).reshape(n, 1, 3)
        centers = torch.cat([robots, goals], dim=1)
        return dr.SceneForRender(
            spheres=sc.Spheres(
                center=centers,
                radius=torch.full((n, r + 1), 0.2, dtype=root.dtype,
                                  device=root.device),
                valid=torch.ones((n, r + 1), dtype=torch.bool,
                                 device=root.device)),
            ground=True)

    # -- step -------------------------------------------------------------

    def step(self, state: MAPlanningState, actions: torch.Tensor,
             generator: Optional[torch.Generator],
             render: Optional[bool] = None
             ) -> Tuple[MAPlanningState, base.StepOutput]:
        cfg = self.cfg
        e, r, n = cfg.num_envs, cfg.num_robots, self.flat_n
        core = state.core

        actions = actions.reshape(n, cfg.num_actions)
        acts = self.remap_actions(actions)
        cmds, ctrl = self.run_controller(core, acts)
        root, rotors = self.physics_step(core, cmds)

        counter = state.counter + 1
        progress = core.progress + 1                       # [E]

        goal_flat = torch.repeat_interleave(state.goal, r, dim=0)   # [n, 3]
        if render is None:
            render = counter % cfg.cam_every == 0
        camera = (dr.render_clean(self.cam_cfg, root,
                                  self.scene(root, state.goal))
                  if render else state.camera)
        esdf = torch.amin(camera.reshape(n, -1), dim=-1)

        # observation (reference maplanning.py:470-514)
        w2l, m_global = yaw_deroll_matrix(root[:, 3:7])
        euler_local = rot.matrix_to_euler_xyz(w2l @ m_global)
        vel_local = torch.einsum("nij,nj->ni", w2l, root[:, 7:10])
        angvel_local = torch.einsum("nij,nj->ni", w2l, root[:, 10:13])
        fwd = goal_flat - root[:, 0:3]
        pos_diff_local = torch.einsum("nij,nj->ni", w2l, fwd)
        related_dist = torch.linalg.norm(fwd, dim=-1)
        goal_dir = pos_diff_local / torch.clamp_min(
            torch.linalg.norm(pos_diff_local, dim=-1, keepdim=True), 1e-6)
        obs_vec = torch.cat(
            [goal_dir, euler_local, vel_local, angvel_local, acts,
             torch.zeros((n, 2 * r), dtype=acts.dtype, device=acts.device)],
            dim=-1)

        collisions = root[:, 2] < assets.ROBOT_COLLISION_RADIUS
        reward, reset_robot, info = self._reward(
            root, acts, core.pre_actions, state.pre_root_pos, goal_flat,
            goal_dir, vel_local, angvel_local, esdf, related_dist,
            collisions)

        # the env resets when any robot is done or the episode ends
        any_robot = torch.any(reset_robot.reshape(e, r), dim=-1)
        env_timeout = progress >= cfg.max_episode_length - 1
        reset_env = any_robot | env_timeout                 # [E]
        reset_flat = torch.repeat_interleave(reset_env, r)  # [n]
        timeout_flat = torch.repeat_interleave(env_timeout & ~any_robot, r)
        env_succ = torch.any(info["success"].reshape(e, r), dim=-1)
        info["env_success"] = torch.repeat_interleave(env_succ, r)
        info["env_done"] = reset_flat

        goal = torch.where(reset_env[:, None],
                           self._reset_goal(generator, e), state.goal)
        new_root = self._reset_root(generator, goal, e)
        m = reset_flat[:, None]
        zero = torch.zeros((), dtype=root.dtype, device=root.device)
        root_after = torch.where(m, new_root, root)
        core = core._replace(
            root=root_after,
            ctrl=px4.reset_state(ctrl, reset_flat, root_after[:, 3:7]),
            progress=torch.where(reset_env, torch.zeros_like(progress),
                                 progress),
            pre_actions=torch.where(m, zero, acts),
            reset_buf=reset_flat,
            rotors=torch.where(m, zero, rotors))
        pre_pos = torch.where(m, zero, root[:, 0:3])

        kw = dict(dtype=goal.dtype, device=goal.device)
        idq = torch.tensor([0.0, 0.0, 0.0, 1.0], **kw).expand(e, 1, 4)
        ball_roots = torch.cat([goal[:, None, :], idq,
                                torch.zeros((e, 1, 6), **kw)], dim=-1)
        out = base.StepOutput(
            obs={"image": camera, "observation": obs_vec},
            priv_obs=ball_roots, reward=reward,
            reset=reset_robot,          # per-robot done flags (reference)
            timeout=timeout_flat, info=info)
        return MAPlanningState(core=core, goal=goal, camera=camera,
                               esdf=esdf, counter=counter,
                               pre_root_pos=pre_pos), out

    def _reward(self, root, actions, pre_actions, pre_root_pos, goal,
                goal_dir, vel_local, angvel_local, esdf, related_dist,
                collisions):
        """Reference maplanning.py:523-581, term by term."""
        adiff = torch.linalg.norm(actions - pre_actions, dim=-1)
        cont_r = 0.2 * torch.linalg.norm(angvel_local, dim=-1) + 0.2 * adiff
        thrust_r = 0.5 * (1.0 - torch.abs(0.1533 - actions[..., -1]))
        forward_r = 0.1 * (torch.linalg.norm(goal - pre_root_pos, dim=-1)
                           - torch.linalg.norm(goal - root[:, 0:3], dim=-1))
        heading_r = goal_dir[:, 0]
        speed_r = -0.5 * (1.0 - torch.exp(
            -2.0 * torch.square(vel_local[..., 0] - 1.0)))
        z = root[:, 2]
        z_r = torch.minimum(torch.clamp_max(z - (FLY_HEIGHT + 0.3), 0.0),
                            (FLY_HEIGHT - 0.3) - z)
        ups = rot.quat_axis(root[:, 3:7], 2)[:, 2]
        ups_r = torch.square((ups + 1.0) / 2.0)
        esdf_r = 0.5 * (1.0 - torch.exp(-0.5 * torch.square(esdf)))
        alive_r = torch.where(esdf > 0.3, 0.0, -1.0).to(z.dtype)
        reach_goal = related_dist < 0.3
        reach_r = torch.where(reach_goal, 200.0, 0.0).to(z.dtype)

        reward = (cont_r + forward_r + alive_r + esdf_r + ups_r + z_r
                  + speed_r + heading_r + thrust_r + reach_r)

        reset_robot = (z > FLY_HEIGHT + 0.3) | collisions | reach_goal

        info = {
            "continous_action_reward": cont_r,
            "heading_reward": heading_r,
            "speed_reward": speed_r,
            "forward_reward": forward_r,
            "alive_reward": alive_r,
            "ups_reward": ups_r,
            "z_reward": z_r,
            "esdf_reward": esdf_r,
            "thrust_reward": thrust_r,
            "reach_goal_reward": reach_r,
            "reward": reward,
            # the per-robot goal flag the trainer's success rate reads
            "success": reach_goal,
        }
        return reward, reset_robot, info
