"""Avoid task (counterpart of airgym_tpu/envs/avoid.py).

Hold position at (0, 0, 1) while dodging a cube thrown at the drone.
Obs = {image [N,1,212,120] depth, observation [N,16]}, observation =
[pos - target, euler_local, vel_local, angvel_local, actions] in the
yaw-aligned local frame. The cube launch solves the ballistic intercept:
80% of resets throw it from radius 4.2 m, theta ~ +-30 deg, z 1.4 at
4.5 m/s ground speed toward a point within 0.3 m of (0, 0, 1); 20% park
it at (-999, -999, 0). The cube flies ballistically
(physics/quadrotor.ballistic_step) and rests once its centre reaches
z 0.5 (the JAX package's rest height, though the cube's half extent is
0.15). A collision (the cube within the 0.2 m body sphere, or ground
contact) gives alive -500 and resets; ``info["success"]`` is the
episode's time-out, i.e. the drone survived the throw. Episode 6 s.

The camera renders every ``cam_every`` (4) steps through the fused
render + post-process kernel (render/raycast.py): one box and the
ground, too few records to cull.

Draw order of ``step`` on the generator: the camera's 32-bit seed, then
the drone reset (xy, z, roll / pitch, yaw) and the cube reset (parked
share, launch angle, aim point), drawn for every env and used where an
env resets.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from airgym_tpu_torch import assets
from airgym_tpu_torch.envs import base
from airgym_tpu_torch.math import rotations as rot
from airgym_tpu_torch.physics import quadrotor as qd
from airgym_tpu_torch.physics import scene as sc
from airgym_tpu_torch.render import depth as dr


@dataclasses.dataclass(frozen=True)
class AvoidCfg(base.BaseEnvCfg):
    num_envs: int = 64
    episode_length_s: float = 6.0
    reset_on_collision: bool = True
    create_ground_plane: bool = True
    cam_dt: float = 0.04
    cam_width: int = 212
    cam_height: int = 120
    target_pos: tuple = (0.0, 0.0, 1.0)
    enable_onboard_cameras: bool = True

    @property
    def cam_every(self) -> int:
        return int(round(self.cam_dt / self.dt))


class AvoidState(NamedTuple):
    core: base.EnvState
    obj: torch.Tensor             # [N, 13] cube root states
    camera: torch.Tensor          # [N, 1, W, H] last rendered image
    counter: int                  # steps since the start (camera cadence)
    pre_root_pos: torch.Tensor    # [N, 3]


def yaw_deroll_matrix(q_xyzw: torch.Tensor):
    """-> (world->local rotation Rz(yaw)^T [.., 3, 3], the attitude
    matrix [.., 3, 3]) (reference avoid.py:208-218)."""
    m = rot.quat_to_matrix(q_xyzw)
    yaw = torch.atan2(m[..., 1, 0], m[..., 0, 0])
    c, s = torch.cos(yaw), torch.sin(yaw)
    z = torch.zeros_like(yaw)
    o = torch.ones_like(yaw)
    w2l = torch.stack([c, s, z, -s, c, z, z, z, o],
                      dim=-1).reshape(q_xyzw.shape[:-1] + (3, 3))
    return w2l, m


def local_state_obs(root: torch.Tensor, target_pos,
                    actions: torch.Tensor) -> torch.Tensor:
    """16-dim local-frame state obs: position relative to the target,
    local euler angles, local linear and angular velocity, the actions."""
    w2l, m_global = yaw_deroll_matrix(root[:, 3:7])
    euler_local = rot.matrix_to_euler_xyz(w2l @ m_global)
    vel_local = torch.einsum("nij,nj->ni", w2l, root[:, 7:10])
    angvel_local = torch.einsum("nij,nj->ni", w2l, root[:, 10:13])
    rel = root[:, 0:3] - torch.as_tensor(target_pos, dtype=root.dtype,
                                         device=root.device)
    return torch.cat([rel, euler_local, vel_local, angvel_local, actions],
                     dim=-1)


class Avoid(base.QuadEnvCore):
    task_name = "avoid"
    action_limit_overrides = {"rate": base.NARROW_RATE_LIMITS}
    num_obs = 16
    obs_is_dict = True
    # info["success"]: the episode reached its time-out, the drone survived
    has_success = True

    def __init__(self, cfg: AvoidCfg, device: torch.device):
        super().__init__(cfg, device)
        self.cam_cfg = dr.CameraCfg(width=cfg.cam_width,
                                    height=cfg.cam_height)
        self.obs_spec = {
            "image": (cfg.num_envs, 1, cfg.cam_width, cfg.cam_height),
            "observation": (cfg.num_envs, self.num_obs),
        }

    def _u(self, generator, *shape):
        """U(-1, 1) draws of ``shape``."""
        return self.rand(generator, *shape) * 2.0 - 1.0

    def initial_state(self, generator: torch.Generator) -> AvoidState:
        n, cfg = self.cfg.num_envs, self.cfg
        root = self._reset_root(generator, n)
        obj = self._reset_object(generator, n)
        cam = torch.zeros((n, 1, cfg.cam_width, cfg.cam_height),
                          dtype=cfg.dtype, device=self.device)
        return AvoidState(core=self.init_core(root), obj=obj, camera=cam,
                          counter=0,
                          pre_root_pos=torch.zeros((n, 3), dtype=cfg.dtype,
                                                   device=self.device))

    # -- resets -----------------------------------------------------------

    def _reset_root(self, generator, n):
        """xy +-0.2, z 1 +- 0.2, roll / pitch 0.01 pi, yaw 0.05 pi, at
        rest (reference avoid.py:127-150)."""
        xy = 0.2 * self._u(generator, n, 2)
        z = 1.0 + 0.2 * self._u(generator, n, 1)
        ang = torch.cat([0.01 * math.pi * self._u(generator, n, 2),
                         0.05 * math.pi * self._u(generator, n, 1)], dim=-1)
        quat = rot.quat_from_euler_xyz(ang)
        zeros = torch.zeros((n, 6), dtype=self.cfg.dtype, device=self.device)
        return torch.cat([xy, z, quat, zeros], dim=-1).to(self.cfg.dtype)

    def _reset_object(self, generator, n):
        """The ballistic launch (reference avoid.py:58-126)."""
        kw = dict(dtype=self.cfg.dtype, device=self.device)
        parked = self.rand(generator, n) >= 0.8
        theta = (math.pi / 6) * self._u(generator, n)
        r = 4.2
        pos = torch.stack([r * torch.cos(theta), r * torch.sin(theta),
                           torch.full((n,), 1.4, **kw)], dim=-1)
        aim = (torch.tensor([0.0, 0.0, 1.0], **kw)
               + 0.3 * self._u(generator, n, 3))
        direction = aim - pos
        dist_xy = torch.linalg.norm(direction[:, :2], dim=-1)
        unit_xy = direction[:, :2] / torch.clamp_min(dist_xy[:, None], 1e-6)
        v_e = 4.5
        t = dist_xy / v_e
        v_z = (aim[:, 2] - pos[:, 2] + 0.5 * 9.81 * t * t) / t
        vel = torch.cat([unit_xy * v_e, v_z[:, None]], dim=-1)

        m = parked[:, None]
        pos = torch.where(m, torch.tensor([-999.0, -999.0, 0.0], **kw), pos)
        vel = torch.where(m, torch.zeros((), **kw), vel)
        s = torch.zeros((n, 13), **kw)
        s[:, 0:3] = pos
        s[:, 6] = 1.0
        s[:, 7:10] = vel
        return s

    # -- scene ------------------------------------------------------------

    def _boxes(self, obj) -> sc.Boxes:
        spec = assets.registry.get_asset("cubes/1x1")
        n = obj.shape[0]
        return sc.Boxes(
            center=obj[:, None, 0:3],
            yaw=torch.zeros((n, 1), dtype=obj.dtype, device=obj.device),
            half_extents=torch.tensor(spec.half_extents, dtype=obj.dtype,
                                      device=obj.device).expand(n, 1, 3),
            valid=torch.ones((n, 1), dtype=torch.bool, device=obj.device))

    def _render(self, root, obj, seed):
        scene = dr.SceneForRender(boxes=self._boxes(obj), ground=True)
        return dr.render_and_process(self.cam_cfg, root, scene, seed)

    # -- step -------------------------------------------------------------

    def step(self, state: AvoidState, actions: torch.Tensor,
             generator: Optional[torch.Generator],
             render: Optional[bool] = None
             ) -> Tuple[AvoidState, base.StepOutput]:
        core = state.core
        cfg = self.cfg
        n = cfg.num_envs
        cam_seed = self.camera_seed(generator)

        acts = self.remap_actions(actions)
        cmds, ctrl = self.run_controller(core, acts)
        root, rotors = self.physics_step(core, cmds)

        # the cube's ballistic flight; it rests once on the ground
        obj = qd.ballistic_step(cfg.dt, self.params.gravity, state.obj)
        grounded = obj[:, 2] <= 0.5
        obj = torch.cat([
            obj[:, 0:2],
            torch.where(grounded, torch.full_like(obj[:, 2], 0.5),
                        obj[:, 2])[:, None],
            obj[:, 3:7],
            torch.where(grounded[:, None], torch.zeros_like(obj[:, 7:10]),
                        obj[:, 7:10]),
            obj[:, 10:13]], dim=-1)

        counter = state.counter + 1
        progress = core.progress + 1

        if render is None:
            render = counter % cfg.cam_every == 0
        camera = (self._render(root, obj, cam_seed) if render
                  else state.camera)

        obs_vec = local_state_obs(root, cfg.target_pos, acts)

        # collisions: the cube within the 0.2 m body sphere, or the ground
        cube_d = sc.dist_to_boxes(root[:, 0:3], self._boxes(obj))[:, 0]
        collisions = ((cube_d < assets.ROBOT_COLLISION_RADIUS)
                      | (root[:, 2] < assets.ROBOT_COLLISION_RADIUS))

        reward, die, info = self._reward(root, acts, core.pre_actions,
                                         collisions)
        die = die | collisions
        max_len = cfg.max_episode_length
        timeout = (progress >= max_len - 1) & ~die
        reset = die | (progress >= max_len - 1)
        info["success"] = timeout

        new_root = self._reset_root(generator, n)
        new_obj = self._reset_object(generator, n)
        core = core._replace(root=root, ctrl=ctrl, rotors=rotors,
                             progress=progress, pre_actions=acts)
        core = self.apply_reset(core, reset, new_root)
        obj = torch.where(reset[:, None], new_obj, obj)
        pre_pos = torch.where(reset[:, None], torch.zeros((), dtype=root.dtype,
                                                          device=root.device),
                              root[:, 0:3])

        out = base.StepOutput(
            obs={"image": camera, "observation": obs_vec},
            priv_obs=obj[:, None, :], reward=reward, reset=reset,
            timeout=timeout, info=info)
        return AvoidState(core=core, obj=obj, camera=camera, counter=counter,
                          pre_root_pos=pre_pos), out

    def _reward(self, root, actions, pre_actions, collisions):
        """Reference avoid.py:246-322, term by term."""
        target = torch.tensor(self.cfg.target_pos, dtype=root.dtype,
                              device=root.device)
        rel = target - root[:, 0:3]

        euler = rot.quat_to_euler_xyz(root[:, 3:7])
        rel_heading = rot.yaw_diff(torch.zeros_like(euler[..., 2]),
                                   euler[..., 2])
        distance = torch.linalg.norm(
            torch.cat([rel, rel_heading[:, None]], dim=-1), dim=-1)
        pose_r = 1.0 / (1.0 + torch.square(1.6 * distance))

        ups = rot.quat_axis(root[:, 3:7], 2)[:, 2]
        ups_r = torch.square((ups + 1.0) / 2.0)
        spin = torch.square(root[:, 12])
        spin_r = 1.0 / (1.0 + torch.square(spin))

        effort_r = 0.1 * torch.exp(-torch.sum(torch.square(actions), dim=-1))
        adiff = torch.linalg.norm(actions[..., :-1] - pre_actions[..., :-1],
                                  dim=-1)
        thrust_r = 0.05 * (1.0 - torch.abs(0.1533 - actions[..., -1]))
        smooth_r = 0.1 * torch.exp(-adiff)
        alive_r = torch.where(collisions, -500.0, 0.5).to(root.dtype)

        reward = (pose_r + pose_r * (ups_r + spin_r) + effort_r + smooth_r
                  + thrust_r + alive_r)

        die = root[:, 2] < 0.3
        die |= root[:, 2] > 1.7
        die |= torch.linalg.norm(rel, dim=-1) > 2.0
        die |= ups < 0.0

        info = {
            "pose_reward": pose_r,
            "ups_reward": ups_r,
            "spin_reward": spin_r,
            "effort_reward": effort_r,
            "action_smoothness_reward": smooth_r,
            "thrust_reward": thrust_r,
            "alive_reward": alive_r,
            "reward": reward,
        }
        return reward, die, info
