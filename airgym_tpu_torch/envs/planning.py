"""Planning task (counterpart of airgym_tpu/envs/planning.py).

Fly down a 17 x 8 m corridor through 40 random thin trees to a goal ball
with a depth camera and a local-frame state. Obs = {image [N,1,212,120],
observation [N,16]}, observation = [goal_dir_local(3), euler_local(3),
vel_local(3), angvel_local(3), actions(4)].

Scene per env: 40 tree cylinders at x ~ +-LENGTH, y ~ +-WIDTH with random
yaw and a variant drawn from the 100 reference URDFs; the goal at
(LENGTH + 0.5, +-1.5, 1.5); the drone starts at (-LENGTH - 0.5, 0, 1.5)
yawed toward the goal. The camera renders every ``cam_every`` (4) steps
through the fused render + post-process kernel (render/raycast.py); the
esdf reward term is the minimum of the post-processed image. Rewards and
terminations are the reference's term by term; trees never collide with
the drone (the reference's collision masks), the ground does.

Draw order of ``step`` on the generator: the camera's 32-bit seed, then
the tree placements, tree yaws and goal offsets of the scene reset (drawn
for every env, used where an env resets).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from airgym_tpu_torch import assets
from airgym_tpu_torch.envs import base
from airgym_tpu_torch.envs.avoid import yaw_deroll_matrix
from airgym_tpu_torch.math import rotations as rot
from airgym_tpu_torch.physics import scene as sc
from airgym_tpu_torch.render import depth as dr

LENGTH = 8.0
WIDTH = 4.0
FLY_HEIGHT = 1.5


@dataclasses.dataclass(frozen=True)
class PlanningCfg(base.BaseEnvCfg):
    num_envs: int = 64
    episode_length_s: float = 16.0
    reset_on_collision: bool = True
    create_ground_plane: bool = True
    cam_dt: float = 0.04
    cam_width: int = 212
    cam_height: int = 120
    num_trees: int = 40
    # curriculum knob: start x instead of -LENGTH - 0.5 (None = reference)
    start_x: Optional[float] = None

    @property
    def cam_every(self) -> int:
        return int(round(self.cam_dt / self.dt))


class PlanningState(NamedTuple):
    core: base.EnvState
    goal: torch.Tensor            # [N, 3]
    tree_variant: torch.Tensor    # [N, T] int64 (fixed per env lifetime)
    tree_pos: torch.Tensor        # [N, T, 2]
    tree_yaw: torch.Tensor        # [N, T]
    camera: torch.Tensor          # [N, 1, W, H]
    esdf: torch.Tensor            # [N] min of the camera image
    counter: int                  # steps since the start (camera cadence)
    pre_root_pos: torch.Tensor    # [N, 3]


class Planning(base.QuadEnvCore):
    task_name = "planning"
    action_limit_overrides = {"rate": base.NARROW_RATE_LIMITS}
    num_obs = 16
    obs_is_dict = True
    # info["success"]: the episode ended by reaching the goal ball
    has_success = True

    def __init__(self, cfg: PlanningCfg, device: torch.device):
        super().__init__(cfg, device)
        self.cam_cfg = dr.CameraCfg(width=cfg.cam_width,
                                    height=cfg.cam_height)
        self.cam_every = cfg.cam_every
        self.obs_spec = {
            "image": (cfg.num_envs, 1, cfg.cam_width, cfg.cam_height),
            "observation": (cfg.num_envs, self.num_obs),
        }

    def _uniform(self, generator, *shape):
        return torch.rand(shape, generator=generator, dtype=self.cfg.dtype,
                          device=self.device)

    # -- resets -----------------------------------------------------------

    def _reset_scene(self, generator, n):
        """Tree placement + goal (reference planning.py:66-82)."""
        t = self.cfg.num_trees
        scale = torch.tensor([LENGTH, WIDTH], dtype=self.cfg.dtype,
                             device=self.device)
        pos = (self._uniform(generator, n, t, 2) * 2.0 - 1.0) * scale
        yaw = self._uniform(generator, n, t) * (2.0 * math.pi) - math.pi
        goal_y = 1.5 * (self._uniform(generator, n) * 2.0 - 1.0)
        goal = torch.stack([torch.full_like(goal_y, LENGTH + 0.5), goal_y,
                            torch.full_like(goal_y, FLY_HEIGHT)], dim=-1)
        return pos, yaw, goal

    def _reset_root(self, goal, n):
        """Start at (-L - 0.5, 0, FLY_HEIGHT) yawed toward the goal, at
        rest (reference planning.py:84-112)."""
        x0 = (-LENGTH - 0.5 if self.cfg.start_x is None
              else float(self.cfg.start_x))
        start = torch.tensor([x0, 0.0, FLY_HEIGHT], dtype=self.cfg.dtype,
                             device=self.device).expand(n, 3)
        init_yaw = torch.atan2(goal[:, 1] - start[:, 1],
                               goal[:, 0] - start[:, 0])
        zeros = torch.zeros_like(init_yaw)
        quat = rot.quat_from_euler_xyz(
            torch.stack([zeros, zeros, init_yaw], dim=-1))
        return torch.cat([start, quat, torch.zeros((n, 6), dtype=quat.dtype,
                                                   device=self.device)],
                         dim=-1).to(self.cfg.dtype)

    def initial_state(self, generator: torch.Generator) -> PlanningState:
        n, cfg = self.cfg.num_envs, self.cfg
        variant = torch.randint(0, 100, (n, cfg.num_trees),
                                generator=generator, device=self.device)
        tree_pos, tree_yaw, goal = self._reset_scene(generator, n)
        root = self._reset_root(goal, n)
        cam = torch.zeros((n, 1, cfg.cam_width, cfg.cam_height),
                          dtype=cfg.dtype, device=self.device)
        return PlanningState(
            core=self.init_core(root), goal=goal, tree_variant=variant,
            tree_pos=tree_pos, tree_yaw=tree_yaw, camera=cam,
            esdf=torch.full((n,), 10.0, dtype=cfg.dtype, device=self.device),
            counter=0, pre_root_pos=torch.zeros((n, 3), dtype=cfg.dtype,
                                                device=self.device))

    # -- scene ------------------------------------------------------------

    def scene(self, state: PlanningState) -> dr.SceneForRender:
        """The trees, the goal ball and the ground plane."""
        n = state.goal.shape[0]
        cyl = assets.tree_cylinders_from_placement(
            state.tree_variant, state.tree_pos, state.tree_yaw)
        ball = sc.Spheres(
            center=state.goal[:, None, :],
            radius=torch.full((n, 1), 0.2, dtype=state.goal.dtype,
                              device=state.goal.device),
            valid=torch.ones((n, 1), dtype=torch.bool,
                             device=state.goal.device))
        return dr.SceneForRender(cylinders=cyl, spheres=ball, ground=True)

    def _render(self, root, state, seed):
        return dr.render_and_process(self.cam_cfg, root, self.scene(state),
                                     seed)

    # -- step -------------------------------------------------------------

    def step(self, state: PlanningState, actions: torch.Tensor,
             generator: Optional[torch.Generator],
             render: Optional[bool] = None
             ) -> Tuple[PlanningState, base.StepOutput]:
        core = state.core
        cfg = self.cfg
        n = cfg.num_envs
        cam_seed = torch.randint(0, 2 ** 32, (), generator=generator,
                                 dtype=torch.int64, device=self.device)

        acts = self.remap_actions(actions)
        cmds, ctrl = self.run_controller(core, acts)
        root, rotors = self.physics_step(core, cmds)
        counter = state.counter + 1
        progress = core.progress + 1

        if render is None:
            render = counter % cfg.cam_every == 0
        camera = (self._render(root, state, cam_seed) if render
                  else state.camera)
        esdf = torch.amin(camera.reshape(n, -1), dim=-1)

        # observation (reference planning.py:186-219)
        w2l, m_global = yaw_deroll_matrix(root[:, 3:7])
        euler_local = rot.matrix_to_euler_xyz(w2l @ m_global)
        vel_local = torch.einsum("nij,nj->ni", w2l, root[:, 7:10])
        angvel_local = torch.einsum("nij,nj->ni", w2l, root[:, 10:13])
        fwd_global = state.goal - root[:, 0:3]
        pos_diff_local = torch.einsum("nij,nj->ni", w2l, fwd_global)
        related_dist = torch.linalg.norm(fwd_global, dim=-1)
        goal_dir = pos_diff_local / torch.clamp_min(
            torch.linalg.norm(pos_diff_local, dim=-1, keepdim=True), 1e-6)
        obs_vec = torch.cat([goal_dir, euler_local, vel_local, angvel_local,
                             acts], dim=-1)

        collisions = root[:, 2] < assets.ROBOT_COLLISION_RADIUS
        reward, die, info = self._reward(
            root, acts, core.pre_actions, state.pre_root_pos, state.goal,
            goal_dir, vel_local, angvel_local, esdf, related_dist)
        die = die | collisions
        max_len = cfg.max_episode_length
        timeout = (progress >= max_len - 1) & ~die
        reset = die | (progress >= max_len - 1)

        # re-randomise the scene and the root of the envs that reset
        new_pos, new_yaw, new_goal = self._reset_scene(generator, n)
        goal = torch.where(reset[:, None], new_goal, state.goal)
        tree_pos = torch.where(reset[:, None, None], new_pos, state.tree_pos)
        tree_yaw = torch.where(reset[:, None], new_yaw, state.tree_yaw)

        core = core._replace(root=root, ctrl=ctrl, rotors=rotors,
                             progress=progress, pre_actions=acts)
        core = self.apply_reset(core, reset, self._reset_root(goal, n))
        pre_pos = torch.where(reset[:, None], torch.zeros((), dtype=root.dtype,
                                                          device=root.device),
                              root[:, 0:3])

        out = base.StepOutput(
            obs={"image": camera, "observation": obs_vec},
            priv_obs=self._asset_root_states(goal, tree_pos, tree_yaw),
            reward=reward, reset=reset, timeout=timeout, info=info)
        return PlanningState(
            core=core, goal=goal, tree_variant=state.tree_variant,
            tree_pos=tree_pos, tree_yaw=tree_yaw, camera=camera, esdf=esdf,
            counter=counter, pre_root_pos=pre_pos), out

    def _asset_root_states(self, goal, tree_pos, tree_yaw):
        """Privileged obs: env-asset root states [N, 1+T, 13] (row 0 the
        goal ball, rows 1..T the trees at z = 0 with yaw quaternions)."""
        n, t = tree_pos.shape[0], tree_pos.shape[1]
        kw = dict(dtype=goal.dtype, device=goal.device)
        idq = torch.tensor([0.0, 0.0, 0.0, 1.0], **kw).expand(n, 1, 4)
        ball = torch.cat([goal[:, None, :], idq,
                          torch.zeros((n, 1, 6), **kw)], dim=-1)
        z = torch.zeros((n, t), **kw)
        half = 0.5 * tree_yaw
        quat = torch.stack([z, z, torch.sin(half), torch.cos(half)], dim=-1)
        trees = torch.cat([tree_pos, z[..., None], quat,
                           torch.zeros((n, t, 6), **kw)], dim=-1)
        return torch.cat([ball, trees], dim=1)

    def _reward(self, root, actions, pre_actions, pre_root_pos, goal,
                goal_dir, vel_local, angvel_local, esdf, related_dist):
        """Reference planning.py:226-307, term by term."""
        adiff = torch.linalg.norm(actions - pre_actions, dim=-1)
        cont_r = 0.2 * torch.linalg.norm(angvel_local, dim=-1) + 0.2 * adiff
        thrust_r = 0.5 * (1.0 - torch.abs(0.1533 - actions[..., -1]))
        forward_r = 0.1 * (torch.linalg.norm(goal - pre_root_pos, dim=-1)
                           - torch.linalg.norm(goal - root[:, 0:3], dim=-1))
        heading_r = goal_dir[:, 0]
        speed_r = -0.5 * (1.0 - torch.exp(
            -2.0 * torch.square(vel_local[..., 0] - 1.0)))
        z = root[:, 2]
        z_r = torch.minimum(torch.clamp_max(z - 1.8, 0.0), 1.2 - z)
        ups = rot.quat_axis(root[:, 3:7], 2)[:, 2]
        ups_r = torch.square((ups + 1.0) / 2.0)
        esdf_r = 0.5 * (1.0 - torch.exp(-0.5 * torch.square(esdf)))
        alive_r = torch.where(esdf > 0.3, 0.0, -1.0).to(z.dtype)
        reach_goal = related_dist < 0.3
        reach_r = torch.where(reach_goal, 200.0, 0.0).to(z.dtype)

        reward = (cont_r + forward_r + alive_r + esdf_r + ups_r + z_r
                  + speed_r + heading_r + thrust_r + reach_r)

        die = z < FLY_HEIGHT - 0.3
        die |= z > FLY_HEIGHT + 0.3
        die |= root[:, 0] < -LENGTH - 0.5
        die |= root[:, 0] > LENGTH + 0.5
        die |= root[:, 1] < -WIDTH
        die |= root[:, 1] > WIDTH
        die |= reach_goal
        die |= heading_r < 0.25

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
            # not a reward term: the per-step goal flag the trainer's
            # episode success rate reads
            "success": reach_goal,
        }
        return reward, die, info
