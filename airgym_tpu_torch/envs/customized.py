"""Customized task, the template users subclass for new vision tasks
(counterpart of airgym_tpu/envs/customized.py).

The scene comes from ``assets.manager.AssetManager`` (by default eight
thin trees placed over 8 x 8 m), the drone starts at (-LENGTH - 0.5, 0,
FLY_HEIGHT) with a small random tilt, and a depth camera renders every
``cam_every`` steps through the fused render + post-process kernel (a
camera taller than 126 rows through the raw depth kernel and the plain
post-process, render/depth.render_and_process). Obs = {image [N, 1, W,
H], observation [N, 18] = state_obs18 - target_state}. Contacts with the
ground and with every primitive of the scene end the episode when
``reset_on_collision``; the reward is zero and episodes end by length
only: the ``_reward`` hook is what a new task overrides (with
``_observations`` where it needs another vector).

Each env keeps its scene until it resets: the fresh placements drawn
every step replace the scene of the envs that reset and of no other.

Draw order of ``step`` on the generator: the camera's 32-bit seed, the
observation noise, the reset root's tilt, then the scene's placements
(``AssetManager.draw``), drawn for every env and used where an env
resets.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from airgym_tpu_torch import assets
from airgym_tpu_torch.assets.manager import AssetConfig, AssetManager
from airgym_tpu_torch.envs import base
from airgym_tpu_torch.math import rotations as rot
from airgym_tpu_torch.render import depth as dr

LENGTH = 8.0
WIDTH = 8.0
FLY_HEIGHT = 1.0


@dataclasses.dataclass(frozen=True)
class CustomizedCfg(base.BaseEnvCfg):
    num_envs: int = 16
    episode_length_s: float = 24.0
    reset_on_collision: bool = True
    create_ground_plane: bool = True
    cam_dt: float = 0.04
    # the reference camera block's 212 x 120; any size renders
    cam_width: int = 212
    cam_height: int = 120
    enable_onboard_cameras: bool = True
    target_state: tuple = (1., 0., 0., 0., 1., 0., 0., 0., 1.,
                           0., 0., 0., 0., 0., 0., 0., 0., 0.)
    asset_config: AssetConfig = AssetConfig(
        include_group_asset=(("thin", 8),),
        placement_x=LENGTH, placement_y=WIDTH)

    @property
    def cam_every(self) -> int:
        return int(round(self.cam_dt / self.dt))


class CustomizedState(NamedTuple):
    core: base.EnvState
    scene: dr.SceneForRender      # per-env primitives, ground always on
    asset_states: torch.Tensor    # [N, K, 13] env-asset root states
    camera: torch.Tensor          # [N, 1, W, H]
    counter: int                  # steps since the start (camera cadence)


def merge_reset_scene(reset: torch.Tensor, old, new):
    """Per-env merge of two scenes (or root-state blocks): every tensor
    has the env axis first; the reset envs take ``new``, the others keep
    ``old`` unchanged."""
    if isinstance(old, torch.Tensor):
        mask = reset.reshape((-1,) + (1,) * (old.dim() - 1))
        return torch.where(mask, new, old)
    if old is None or isinstance(old, bool):
        return old
    return type(old)(*[merge_reset_scene(reset, o, nw)
                       for o, nw in zip(old, new)])


class Customized(base.QuadEnvCore):
    task_name = "customized"
    action_limit_overrides = {"rate": base.NARROW_RATE_LIMITS}
    num_obs = 18
    obs_is_dict = True

    def __init__(self, cfg: CustomizedCfg, device: torch.device):
        super().__init__(cfg, device)
        self.cam_cfg = dr.CameraCfg(width=cfg.cam_width,
                                    height=cfg.cam_height)
        self.cam_every = cfg.cam_every
        self.manager = AssetManager(cfg.asset_config, cfg.num_envs)
        self.target = torch.tensor(cfg.target_state, dtype=cfg.dtype,
                                   device=device).expand(cfg.num_envs, -1)
        self.obs_spec = {
            "image": (cfg.num_envs, 1, cfg.cam_width, cfg.cam_height),
            "observation": (cfg.num_envs, self.num_obs),
        }

    def _reset_root(self, generator, n):
        """Start at (-L - 0.5, 0, FLY_HEIGHT), roll / pitch 0.01 pi, yaw
        0.05 pi, at rest."""
        u = lambda *shape: self.rand(generator, *shape) * 2.0 - 1.0
        start = torch.tensor([-LENGTH - 0.5, 0.0, FLY_HEIGHT],
                             dtype=self.cfg.dtype, device=self.device)
        ang = torch.cat([0.01 * math.pi * u(n, 2),
                         0.05 * math.pi * u(n, 1)], dim=-1)
        quat = rot.quat_from_euler_xyz(ang)
        return torch.cat([start.expand(n, 3), quat,
                          torch.zeros((n, 6), dtype=quat.dtype,
                                      device=self.device)],
                         dim=-1).to(self.cfg.dtype)

    def sample_scene(self, generator):
        """A fresh scene for every env from ``generator``."""
        return self.manager.sample_scene(
            lambda *s: self.rand(generator, *s),
            lambda high, *s: self.randint(generator, high, *s))

    def initial_state(self, generator: torch.Generator) -> CustomizedState:
        n, cfg = self.cfg.num_envs, self.cfg
        root = self._reset_root(generator, n)
        scene, states = self.sample_scene(generator)
        cam = torch.zeros((n, 1, cfg.cam_width, cfg.cam_height),
                          dtype=cfg.dtype, device=self.device)
        return CustomizedState(core=self.init_core(root), scene=scene,
                               asset_states=states, camera=cam, counter=0)

    def _render(self, root, state: CustomizedState, seed):
        return dr.render_and_process(self.cam_cfg, root, state.scene, seed)

    def _observations(self, root, generator):
        """The 18-vector less the target state."""
        return self.state_obs18(root, generator) - self.target

    def step(self, state: CustomizedState, actions: torch.Tensor,
             generator: Optional[torch.Generator],
             render: Optional[bool] = None
             ) -> Tuple[CustomizedState, base.StepOutput]:
        cfg = self.cfg
        core = state.core
        cam_seed = self.camera_seed(generator)

        acts = self.remap_actions(actions)
        cmds, ctrl = self.run_controller(core, acts)
        root, rotors = self.physics_step(core, cmds)
        counter = state.counter + 1
        progress = core.progress + 1

        if render is None:
            render = counter % cfg.cam_every == 0
        camera = (self._render(root, state, cam_seed) if render
                  else state.camera)
        obs_vec = self._observations(root, generator)

        # contacts: the body sphere against the ground and every primitive
        # of the scene
        collisions = root[:, 2] < assets.ROBOT_COLLISION_RADIUS
        collisions |= (dr.min_dist_scene(root[:, 0:3], state.scene)
                       < assets.ROBOT_COLLISION_RADIUS)

        reward, die, info = self._reward(root, acts, core.pre_actions,
                                         collisions)
        if cfg.reset_on_collision:
            die = die | collisions
        max_len = cfg.max_episode_length
        timeout = (progress >= max_len - 1) & ~die
        reset = die | (progress >= max_len - 1)

        core = core._replace(root=root, ctrl=ctrl, rotors=rotors,
                             progress=progress, pre_actions=acts)
        core = self.apply_reset(core, reset,
                                self._reset_root(generator, cfg.num_envs))
        # fresh placements for every env, taken only where an env resets
        new_scene, new_states = self.sample_scene(generator)
        scene = merge_reset_scene(reset, state.scene, new_scene)
        asset_states = merge_reset_scene(reset, state.asset_states,
                                         new_states)

        out = base.StepOutput(
            obs={"image": camera, "observation": obs_vec},
            priv_obs=asset_states, reward=reward, reset=reset,
            timeout=timeout, info=info)
        return CustomizedState(core=core, scene=scene,
                               asset_states=asset_states, camera=camera,
                               counter=counter), out

    def _reward(self, root, actions, pre_actions, collisions):
        """Zero reward, no death but by episode length: the hook a
        subclass overrides -> (reward [N], die [N] bool, info)."""
        zero = torch.zeros((self.cfg.num_envs,), dtype=self.cfg.dtype,
                           device=self.device)
        return zero, torch.zeros_like(zero, dtype=torch.bool), \
            {"reward": zero}
