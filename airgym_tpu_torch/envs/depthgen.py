"""DepthGen, the depth-dataset generator (counterpart of
airgym_tpu/envs/depthgen.py).

It renders depth frames for VAE pre-training: 2-step episodes (every
step ends one and resets every env), zero reward, and a small cluttered
scene placed anew at every reset, its assets at x ~ U(0, 3), y ~ U(-2, 2)
with a random yaw, seen from a drone hovering at (-0.3, 0, 0.6 +- 0.15)
with a small random tilt. The scene is 3 thin trees, 3 trees, 3 cubes
and 3 flags (assets.place_group), which pack as 75 cylinders, 72 spheres,
15 boxes and 3 annuli. Each family's variants are drawn once, when the
state is created; only the placements change at resets.

The camera renders every ``cam_every`` (4) steps the clean clamped and
normalised depth (no noise, no blur) through the raw depth kernel
(render/depth.render_depth_auto, csrc/render_depth.cu), of the scene as
it was before the step's reset. ``generate(out_dir, n_frames)`` rolls the
env with zero actions and saves every env's frame as an [H, W] float32
.npy file, the transposed image, as the reference does.

Draw order: ``initial_state`` draws the variants (thin, trees, cubes,
flags), then the placements, then the drone's reset; ``step`` draws the
observation noise, then the placements (per family x, y, then yaw) and
the drone's reset.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from airgym_tpu_torch import assets
from airgym_tpu_torch.envs import base
from airgym_tpu_torch.math import rotations as rot
from airgym_tpu_torch.physics import scene as sc
from airgym_tpu_torch.render import depth as dr

LENGTH = 3.0
WIDTH = 2.0
FLY_HEIGHT = 0.5
FAMILIES = ("thin", "trees", "cubes", "flags")


@dataclasses.dataclass(frozen=True)
class DepthGenCfg(base.BaseEnvCfg):
    num_envs: int = 16
    episode_length_s: float = 8.0     # unused: episodes are 2 steps
    create_ground_plane: bool = True
    cam_dt: float = 0.04
    cam_width: int = 212
    cam_height: int = 120
    num_thin: int = 3
    num_trees: int = 3
    num_cubes: int = 3
    num_flags: int = 3

    @property
    def max_episode_length(self) -> int:
        return 2

    @property
    def cam_every(self) -> int:
        return int(round(self.cam_dt / self.dt))


class DepthGenState(NamedTuple):
    core: base.EnvState
    # variants fixed at creation; positions [N, k, 2] and yaws [N, k]
    # placed anew at every reset
    thin_variant: torch.Tensor
    thin_pos: torch.Tensor
    thin_yaw: torch.Tensor
    tree_variant: torch.Tensor
    tree_pos: torch.Tensor
    tree_yaw: torch.Tensor
    cube_variant: torch.Tensor
    cube_pos: torch.Tensor
    cube_yaw: torch.Tensor
    flag_variant: torch.Tensor
    flag_pos: torch.Tensor
    flag_yaw: torch.Tensor
    camera: torch.Tensor          # [N, 1, W, H]
    counter: int


class DepthGen(base.QuadEnvCore):
    task_name = "depthgen"
    action_limit_overrides = {"rate": base.NARROW_RATE_LIMITS}
    num_obs = 18

    def __init__(self, cfg: DepthGenCfg, device: torch.device):
        super().__init__(cfg, device)
        self.cam_cfg = dr.CameraCfg(width=cfg.cam_width,
                                    height=cfg.cam_height)
        self.target = torch.zeros((cfg.num_envs, 18), dtype=cfg.dtype,
                                  device=device)
        self.target[:, [0, 4, 8]] = 1.0

    def _counts(self):
        c = self.cfg
        return (c.num_thin, c.num_trees, c.num_cubes, c.num_flags)

    def _uniform(self, generator, *shape):
        return self.rand(generator, *shape)

    def _reset_scene(self, generator, n):
        """(pos [n, k, 2], yaw [n, k]) per family: x ~ U(0, L), y ~
        U(-W, W), yaw ~ U(-pi, pi) (reference depthgen.py:355-362)."""
        out = []
        for k in self._counts():
            x = LENGTH * self._uniform(generator, n, k)
            y = WIDTH * (self._uniform(generator, n, k) * 2.0 - 1.0)
            yaw = self._uniform(generator, n, k) * (2.0 * math.pi) - math.pi
            out += [torch.stack([x, y], dim=-1), yaw]
        return out

    def _reset_root(self, generator, n):
        """(-0.3, 0, 0.6 +- 0.15), roll / pitch 0.04 pi, yaw 0.05 pi, at
        rest (reference depthgen.py:371-378)."""
        u = lambda *s: self._uniform(generator, *s) * 2.0 - 1.0
        xy = torch.tensor([-0.3, 0.0], dtype=self.cfg.dtype,
                          device=self.device).expand(n, 2)
        z = FLY_HEIGHT + 0.1 + 0.15 * u(n, 1)
        ang = torch.cat([0.04 * math.pi * u(n, 2),
                         0.05 * math.pi * u(n, 1)], dim=-1)
        quat = rot.quat_from_euler_xyz(ang)
        return torch.cat([xy, z, quat, torch.zeros(
            (n, 6), dtype=self.cfg.dtype, device=self.device)],
            dim=-1).to(self.cfg.dtype)

    def initial_state(self, generator: torch.Generator) -> DepthGenState:
        cfg, n = self.cfg, self.cfg.num_envs
        variants = [self.randint(generator, assets.num_variants(f), n, k)
                    for f, k in zip(FAMILIES, self._counts())]
        scene = self._reset_scene(generator, n)
        root = self._reset_root(generator, n)
        cam = torch.zeros((n, 1, cfg.cam_width, cfg.cam_height),
                          dtype=cfg.dtype, device=self.device)
        return DepthGenState(
            core=self.init_core(root),
            thin_variant=variants[0], thin_pos=scene[0], thin_yaw=scene[1],
            tree_variant=variants[1], tree_pos=scene[2], tree_yaw=scene[3],
            cube_variant=variants[2], cube_pos=scene[4], cube_yaw=scene[5],
            flag_variant=variants[3], flag_pos=scene[6], flag_yaw=scene[7],
            camera=cam, counter=0)

    def scene(self, state: DepthGenState) -> dr.SceneForRender:
        """Every family through place_group, concatenated per kind as the
        JAX package does (cylinders: thin, trees, flags; boxes: cubes,
        flags)."""
        thin = assets.place_group("thin", state.thin_variant,
                                  state.thin_pos, state.thin_yaw)
        trees = assets.place_group("trees", state.tree_variant,
                                   state.tree_pos, state.tree_yaw)
        cubes = assets.place_group("cubes", state.cube_variant,
                                   state.cube_pos, state.cube_yaw)
        flags = assets.place_group("flags", state.flag_variant,
                                   state.flag_pos, state.flag_yaw)

        def cat(cls, parts):
            parts = [p for p in parts if p is not None]
            if not parts:
                return None
            return cls(*[torch.cat(f, dim=1) for f in zip(*parts)])

        return dr.SceneForRender(
            cylinders=cat(sc.Cylinders, [thin.cylinders, trees.cylinders,
                                         flags.cylinders]),
            spheres=cat(sc.Spheres, [trees.spheres]),
            boxes=cat(sc.Boxes, [cubes.boxes, flags.boxes]),
            annuli=cat(sc.Annuli, [flags.annuli]),
            ground=True)

    def step(self, state: DepthGenState, actions: torch.Tensor,
             generator: Optional[torch.Generator]
             ) -> Tuple[DepthGenState, base.StepOutput]:
        core, cfg = state.core, self.cfg
        n = cfg.num_envs

        acts = self.remap_actions(actions)
        cmds, ctrl = self.run_controller(core, acts)
        root, rotors = self.physics_step(core, cmds)
        counter = state.counter + 1
        progress = core.progress + 1

        camera = (dr.render_clean(self.cam_cfg, root, self.scene(state))
                  if counter % cfg.cam_every == 0 else state.camera)

        obs = self.state_obs18(root, generator) - self.target
        reward = torch.zeros((n,), dtype=cfg.dtype, device=self.device)
        reset = progress >= cfg.max_episode_length - 1

        scene = self._reset_scene(generator, n)
        core = core._replace(root=root, ctrl=ctrl, rotors=rotors,
                             progress=progress, pre_actions=acts)
        core = self.apply_reset(core, reset, self._reset_root(generator, n))

        def merge(old, new):
            m = reset.reshape((-1,) + (1,) * (old.dim() - 1))
            return torch.where(m, new, old)

        ns = DepthGenState(
            core=core,
            thin_variant=state.thin_variant,
            thin_pos=merge(state.thin_pos, scene[0]),
            thin_yaw=merge(state.thin_yaw, scene[1]),
            tree_variant=state.tree_variant,
            tree_pos=merge(state.tree_pos, scene[2]),
            tree_yaw=merge(state.tree_yaw, scene[3]),
            cube_variant=state.cube_variant,
            cube_pos=merge(state.cube_pos, scene[4]),
            cube_yaw=merge(state.cube_yaw, scene[5]),
            flag_variant=state.flag_variant,
            flag_pos=merge(state.flag_pos, scene[6]),
            flag_yaw=merge(state.flag_yaw, scene[7]),
            camera=camera, counter=counter)
        out = base.StepOutput(obs=obs, priv_obs=None, reward=reward,
                              reset=reset, timeout=reset, info={})
        return ns, out

    # -- dataset generation -----------------------------------------------

    def generate(self, out_dir: str, n_frames: int, seed: int = 0) -> int:
        """Roll the env with zero actions and save [H, W] float32 .npy
        depth frames (the transposed image) until ``n_frames`` are
        written; returns the count."""
        os.makedirs(out_dir, exist_ok=True)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        state = self.initial_state(gen)
        act = torch.zeros((self.cfg.num_envs, self.cfg.num_actions),
                          dtype=self.cfg.dtype, device=self.device)
        saved = 0
        while saved < n_frames:
            for _ in range(self.cfg.cam_every):
                state, _ = self.step(state, act, gen)
            imgs = state.camera[:, 0].cpu().numpy()          # [N, W, H]
            for i in range(imgs.shape[0]):
                if saved >= n_frames:
                    break
                np.save(os.path.join(out_dir, f"{time.time()}_{i}.npy"),
                        imgs[i].T)
                saved += 1
        return saved
