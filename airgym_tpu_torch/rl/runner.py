"""Training runner (counterpart of airgym_tpu/rl/runner.py, train only).

``Runner().load(yaml_cfg).run(args)`` reads the reference YAML schema
(params.config.* hyperparameters, params.network.* architecture), builds
the task and the trainer, and runs the epochs: per logged epoch it prints
the fps line and records the host-side metrics, and it writes native and
.pth checkpoints at ``save_frequency``, on a new best reward after
``save_best_after``, and at the end. A task with a success notion
(Balloon, Planning, Avoid, MAPlanning) also keeps a
``<name>_best_success`` checkpoint of the best logged success rate: the
env-level rate where the trainer reports one (MAPlanning, whose
per-robot rate is capped near 1 / R), else the per-actor rate.

The trainer is chosen as in the JAX runner: the fused trainer of the
task when the YAML asks for it (``use_fused_rollout``) and the config is
one its kernels cover (rate mode, a multiple of 1024 envs, the
[64,128,64] elu shared-trunk fixed-sigma net), otherwise the plain
``PPO`` (camera tasks, Balloon's shipped 64 envs, other nets).

Play / eval, the metrics writer, multi-GPU runs and the robot-count
curriculum's warm start (``transfer_checkpoint``) are ROADMAP.md queue A
items 9b, 15 and 13b.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict

import numpy as np
import torch

from airgym_tpu_torch import envs
from airgym_tpu_torch.ops import fused_rollout as fr
from airgym_tpu_torch.rl import checkpoint as ckpt
from airgym_tpu_torch.rl import ppo as ppo_mod
from airgym_tpu_torch.rl.fused_ppo import (FusedBalloonPPO, FusedHoveringPPO,
                                           FusedTrackingPPO)

LOGGED = ("mean_reward", "loss", "kl", "lr", "a_loss", "c_loss", "b_loss",
          "entropy", "clip_frac", "mean_ep_length", "reward_raw_per_step",
          "explained_variance")
SUCCESS = ("success_rate", "env_success_rate")

FUSED_TRAINERS = {"hovering": FusedHoveringPPO, "balloon": FusedBalloonPPO,
                  "tracking": FusedTrackingPPO}


def network_kw_from_params(params: Dict[str, Any]) -> Dict[str, Any]:
    net = params.get("network", {})
    mlp = net.get("mlp", {})
    kw: Dict[str, Any] = {}
    if "units" in mlp:
        kw["units"] = tuple(mlp["units"])
    if "activation" in mlp:
        kw["activation"] = mlp["activation"]
    if net.get("separate"):
        kw["separate"] = True
    space = net.get("space", {}).get("continuous", {})
    if "fixed_sigma" in space and not space["fixed_sigma"]:
        kw["fixed_sigma"] = False
    # encoder priority of the reference model build (resnet, cnn, vae)
    for enc in ("resnet", "cnn", "vae"):
        if enc in net:
            kw["image_encoder"] = enc
            if enc == "cnn":
                kw["image_feature_dim"] = int(net["cnn"].get("output_dim",
                                                             30))
            break
    return kw


def ppo_config_from_params(params: Dict[str, Any]) -> ppo_mod.PPOConfig:
    c = params.get("config", {})
    g = lambda k, d: c.get(k, d)
    shaper = g("reward_shaper", {})
    return ppo_mod.PPOConfig(
        horizon=int(g("horizon_length", 24)),
        minibatch_size=int(g("minibatch_size", 2048)),
        mini_epochs=int(g("mini_epochs", 5)),
        gamma=float(g("gamma", 0.99)),
        tau=float(g("tau", 0.95)),
        learning_rate=float(g("learning_rate", 3e-4)),
        lr_schedule=g("lr_schedule", "adaptive"),
        kl_threshold=float(g("kl_threshold", 0.008)),
        e_clip=float(g("e_clip", 0.2)),
        use_smooth_clamp=bool(g("use_smooth_clamp", False)),
        clip_value=bool(g("clip_value", False)),
        critic_coef=float(g("critic_coef", 2.0)),
        entropy_coef=float(g("entropy_coef", 0.0)),
        bounds_loss_coef=float(g("bounds_loss_coef", 1e-4)),
        grad_norm=float(g("grad_norm", 1.5)),
        truncate_grads=bool(g("truncate_grads", True)),
        normalize_input=bool(g("normalize_input", True)),
        normalize_value=bool(g("normalize_value", True)),
        normalize_advantage=bool(g("normalize_advantage", True)),
        value_bootstrap=bool(g("value_bootstrap", True)),
        reward_shaper_scale=float(shaper.get("scale_value", 1.0)
                                  if isinstance(shaper, dict) else 1.0),
        max_epochs=int(g("max_epochs", 200)),
        save_frequency=int(g("save_frequency", 100)),
        save_best_after=int(g("save_best_after", 10)),
        score_to_win=float(g("score_to_win", 1e5)),
    )


class Runner:
    def __init__(self):
        self.params: Dict[str, Any] = {}

    def load(self, yaml_cfg: Dict[str, Any]):
        self.params = yaml_cfg.get("params", yaml_cfg)
        return self

    def network_kw(self) -> Dict[str, Any]:
        """The trainer's ``PPO(network_kw=...)``: the YAML's network."""
        return network_kw_from_params(self.params)

    def build(self, args: Dict[str, Any]):
        cfg = self.params.get("config", {})
        task_name = args.get("task") or cfg.get("env_name", "hovering")
        num_envs = int(args.get("num_envs") or cfg.get("num_actors", 256))
        ctl_mode = args.get("ctl_mode", "rate")
        seed = args.get("seed")
        seed = int(self.params.get("seed", 42) if seed is None else seed)
        if seed == -1:
            seed = int(np.random.randint(0, 2 ** 31 - 1))
        env_kw = dict(cfg.get("env_config", {}) or {})
        env_kw.pop("seed", None)
        use_image = env_kw.pop("use_image", None)
        task = envs.make_task(task_name, ctl_mode=ctl_mode,
                              num_envs=num_envs, device=args.get("device"),
                              **env_kw)
        if use_image is not None and bool(use_image) != task.obs_is_dict:
            raise ValueError(
                f"env_config.use_image={use_image} contradicts task "
                f"{task_name!r} (obs_is_dict={task.obs_is_dict})")
        network_kw = self.network_kw()
        fused = (cfg.get("use_fused_rollout") and ctl_mode == "rate"
                 and task_name in FUSED_TRAINERS
                 and num_envs % fr.TILE == 0
                 and tuple(network_kw.get("units", fr.UNITS)) == fr.UNITS
                 and network_kw.get("activation", "elu") == "elu"
                 and not network_kw.get("separate")
                 and network_kw.get("fixed_sigma", True))
        trainer_cls = FUSED_TRAINERS[task_name] if fused else ppo_mod.PPO
        trainer = trainer_cls(task, ppo_config_from_params(self.params),
                              network_kw=network_kw)
        return task, trainer, seed

    def run(self, args: Dict[str, Any]):
        if not args.get("train", True):
            raise NotImplementedError(
                "play / eval is not ported yet: ROADMAP.md queue A item 9b")
        return self.run_train(args)

    def run_train(self, args: Dict[str, Any]):
        task, trainer, seed = self.build(args)
        cfg = trainer.cfg
        name = self.params.get("config", {}).get("name", task.task_name)
        run_dir = os.path.join(args.get("run_root") or "runs",
                               f"{name}_{time.strftime('%d-%H-%M-%S')}")
        ck_dir = os.path.join(run_dir, "nn")
        ts = trainer.init(seed)
        if args.get("checkpoint"):
            ts = ckpt.restore(ts, ckpt.load(args["checkpoint"]))
        elif args.get("transfer_checkpoint"):
            raise NotImplementedError(
                "warm starts across observation widths (the robot-count "
                "curriculum, checkpoint.transfer_obs_width) are not ported "
                "yet: ROADMAP.md queue A item 13b")
        log_every = max(1, int(args.get("log_every")
                               or max(1, cfg.max_epochs // 50)))
        cuda = trainer.device.type == "cuda"
        history = []
        best_reward = -1e9
        best_success = 0.0     # saved only once the task actually succeeds
        start = t_last = time.time()
        frames_since = 0
        epoch = ts.epoch
        while epoch < cfg.max_epochs:
            ts, m = trainer.train_epoch(ts)
            epoch = ts.epoch
            frames_since += trainer.batch_size
            if epoch % log_every and epoch < cfg.max_epochs:
                continue
            if cuda:
                torch.cuda.synchronize(trainer.device)
            now = time.time()
            row = {k: float(m[k]) for k in LOGGED + SUCCESS if k in m}
            row.update(epoch=epoch, frames=ts.frame,
                       seconds=now - t_last,
                       fps=frames_since / max(now - t_last, 1e-9))
            t_last, frames_since = now, 0
            history.append(row)
            print(f"fps total: {row['fps']:.0f} epoch: {epoch}/"
                  f"{cfg.max_epochs} frames: {ts.frame} "
                  f"mean_reward: {row['mean_reward']:.2f} "
                  f"loss: {row['loss']:.4f} kl: {row['kl']:.5f} "
                  f"lr: {row['lr']:.2e}"
                  + "".join(f" {k}: {row[k]:.3f}" for k in SUCCESS
                            if k in row), flush=True)
            if epoch >= cfg.save_best_after and \
                    row["mean_reward"] > best_reward:
                best_reward = row["mean_reward"]
                self.save(ts, os.path.join(ck_dir, name), best_reward)
            gate = ("env_success_rate" if "env_success_rate" in row
                    else "success_rate")
            if epoch >= cfg.save_best_after and \
                    row.get(gate, 0.0) > best_success:
                best_success = row[gate]
                self.save(ts, os.path.join(ck_dir, f"{name}_best_success"),
                          row["mean_reward"])
            if cfg.save_frequency and epoch % cfg.save_frequency == 0:
                self.save(ts, os.path.join(ck_dir,
                                           f"last_{name}_ep_{epoch}"),
                          row["mean_reward"])
            if row["mean_reward"] > cfg.score_to_win:
                break
        last = os.path.join(ck_dir, f"last_{name}")
        self.save(ts, last, history[-1]["mean_reward"] if history else -1e9)
        info = {"best_reward": best_reward, "epochs": epoch,
                "wall_time_s": time.time() - start, "run_dir": run_dir,
                "checkpoint": last + ".pt", "history": history}
        if task.has_success:
            info["best_success"] = best_success
        return ts, info

    @staticmethod
    def save(ts, path_no_ext: str, mean_reward: float = -1e9) -> None:
        ckpt.save(path_no_ext + ".pt", ts)
        ckpt.export_pth(path_no_ext + ".pth", ts, mean_reward)
