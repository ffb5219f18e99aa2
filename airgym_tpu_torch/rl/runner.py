"""Training / eval runner (counterpart of airgym_tpu/rl/runner.py).

``Runner().load(yaml_cfg).run(args)`` reads the reference YAML schema
(params.config.* hyperparameters, params.network.* architecture), builds
the task and the trainer, and trains (``args["train"]``) or plays a
checkpoint.

Training runs the epochs: per logged epoch it prints the fps line,
records the host-side metrics and writes the reference's scalars through
``rl/metrics.MetricsWriter`` (``run_dir/events.jsonl``), and it writes
native and .pth checkpoints at ``save_frequency``, on a new best reward
after ``save_best_after``, and at the end. A task with a success notion
(Balloon, Planning, Avoid, MAPlanning) also keeps a
``<name>_best_success`` checkpoint of the best logged success rate: the
env-level rate where the trainer reports one (MAPlanning, whose
per-robot rate is capped near 1 / R), else the per-actor rate.
``config.viz_every_epochs`` dumps a short episode of the current policy
to ``run_dir/viz/epoch_%06d`` (``utils/episode_viz``).

The trainer is chosen as in the JAX runner: the fused trainer of the
task when the YAML asks for it (``use_fused_rollout``) and the config is
one its kernels cover (rate mode, a multiple of 1024 envs, the
[64,128,64] elu shared-trunk fixed-sigma net), otherwise the plain
``PPO`` (camera tasks, Balloon's shipped 64 envs, other control modes,
other nets).

A ``vae:`` / ``resnet:`` block with a ``model_file`` grafts a pretrained
encoder after ``trainer.init`` (``_maybe_load_pretrained_vae``), in train
and play; a later ``checkpoint`` overwrites it. ``transfer_checkpoint``
with ``transfer_old_obs_dim`` warm-starts a native checkpoint across
observation widths (the robot-count curriculum,
``checkpoint.transfer_obs_width``).

Play (``Player``) evaluates the policy's clamped mean in chunks of steps
and reports the mean reward per finished episode and, where the task has
one, the success rate. Multi-GPU runs are ROADMAP.md queue A item 15.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from airgym_tpu_torch import envs
from airgym_tpu_torch.ops import fused_rollout as fr
from airgym_tpu_torch.rl import checkpoint as ckpt
from airgym_tpu_torch.rl import metrics as metrics_mod
from airgym_tpu_torch.rl import ppo as ppo_mod
from airgym_tpu_torch.rl.fused_ppo import (FusedBalloonPPO, FusedHoveringPPO,
                                           FusedTrackingPPO)

LOGGED = ("mean_reward", "loss", "kl", "lr", "a_loss", "c_loss", "b_loss",
          "entropy", "clip_frac", "mean_ep_length", "reward_raw_per_step",
          "explained_variance")
SUCCESS = ("success_rate", "env_success_rate")

# the reference's scalar tags of a logged epoch (reference
# a2c_base.py / a2c_continuous.py) -> the runner's history keys
TAGS = {"losses/a_loss": "a_loss", "losses/c_loss": "c_loss",
        "losses/bounds_loss": "b_loss", "losses/entropy": "entropy",
        "info/last_lr": "lr", "info/kl": "kl", "info/epochs": "epoch",
        "performance/step_inference_rl_update_fps": "fps",
        "rewards/frame": "mean_reward", "rewards/iter": "mean_reward",
        "episode_lengths/frame": "mean_ep_length",
        "diagnostics/clip_frac": "clip_frac",
        "diagnostics/explained_variance": "explained_variance",
        "info/success_rate": "success_rate",
        "info/env_success_rate": "env_success_rate"}

FUSED_TRAINERS = {"hovering": FusedHoveringPPO, "balloon": FusedBalloonPPO,
                  "tracking": FusedTrackingPPO}


def network_kw_from_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """The reference network YAML block -> ActorCritic kwargs."""
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
    # encoder priority of the reference model build: resnet, cnn, vae
    if "resnet" in net:
        kw["image_encoder"] = "resnet"
        kw["image_feature_dim"] = int(net["resnet"].get("output_dim", 30))
        rtype = net["resnet"].get("type", "resnet18")
        if rtype != "resnet18":
            raise ValueError(f"resnet type {rtype!r} unsupported "
                             "(the reference uses resnet18)")
    elif "cnn" in net:
        kw["image_encoder"] = "cnn"
        kw["image_feature_dim"] = int(net["cnn"].get("output_dim", 30))
    elif "vae" in net:
        kw["image_encoder"] = "vae"
        kw["vae_latent_dim"] = int(net["vae"].get("latent_dims", 64))
        if net["vae"].get("return_sampled_latent"):
            raise NotImplementedError(
                "return_sampled_latent: True is not supported; the policy "
                "encoder returns deterministic means like the shipped "
                "reference configs (return_sampled_latent: False)")
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
        if args.get("train", True):
            return self.run_train(args)
        return self.run_play(args)

    def _maybe_load_pretrained_vae(self, ts):
        """Graft pretrained frozen encoder weights into the model.

        ``vae: {model_folder, model_file}``: a torch ``vae_model.pth``
        (its encoder; the RL model holds no decoder). ``resnet:
        {model_folder, model_file}``: a torchvision resnet18 state dict
        (``conv1`` summed over RGB; the model keeps its own ``fc``).
        Without either block ``ts`` comes back as it is."""
        net = self.params.get("network", {})
        vae_cfg = net.get("vae") or {}
        resnet_cfg = net.get("resnet") or {}

        def load_sd(cfg):
            path = os.path.join(cfg.get("model_folder", "."),
                                cfg["model_file"])
            sd = torch.load(path, map_location="cpu", weights_only=False)
            if isinstance(sd, dict) and "model_state_dict" in sd:
                sd = sd["model_state_dict"]
            return sd

        model = ts.model
        if vae_cfg.get("model_file"):
            from airgym_tpu_torch.models import vae as vae_mod
            sd = vae_mod.import_torch_state_dict(load_sd(vae_cfg))
            if model.image_encoder == "vae":
                model.actor_enc.encoder.load_state_dict(
                    {k[len("encoder."):]: v for k, v in sd.items()
                     if k.startswith("encoder.")})
        elif resnet_cfg.get("model_file"):
            from airgym_tpu_torch.models import resnet as resnet_mod
            sd = resnet_mod.import_torchvision_state_dict(
                load_sd(resnet_cfg), int(resnet_cfg.get("output_dim", 30)))
            if model.image_encoder == "resnet":
                # the model keeps its own fc
                sd.update({f"fc.{k}": v for k, v in
                           model.actor_resnet.fc.state_dict().items()})
                model.actor_resnet.load_state_dict(sd)
        return ts

    def run_play(self, args: Dict[str, Any]):
        task, trainer, seed = self.build(args)
        player = Player(task, trainer)
        player.ts = self._maybe_load_pretrained_vae(player.ts)
        if args.get("checkpoint"):
            player.restore(args["checkpoint"])
        games = int(self.params.get("config", {}).get(
            "player", {}).get("games_num", 10))
        return player.run(max_steps=int(args.get("max_steps") or 1000),
                          seed=seed, record_dir=args.get("record_dir"),
                          games_num=games)

    def run_train(self, args: Dict[str, Any]):
        task, trainer, seed = self.build(args)
        cfg = trainer.cfg
        name = self.params.get("config", {}).get("name", task.task_name)
        run_dir = os.path.join(args.get("run_root") or "runs",
                               f"{name}_{time.strftime('%d-%H-%M-%S')}")
        ck_dir = os.path.join(run_dir, "nn")
        writer = metrics_mod.MetricsWriter(run_dir)
        ts = self._maybe_load_pretrained_vae(trainer.init(seed))
        if args.get("checkpoint"):
            ts = restore(ts, args["checkpoint"])
        elif args.get("transfer_checkpoint"):
            # the caller states the SOURCE obs-vector width; the target
            # width is this task's own
            if args.get("transfer_old_obs_dim") is None:
                raise ValueError(
                    "transfer_checkpoint needs transfer_old_obs_dim, the "
                    "source checkpoint's obs-vector width")
            ts = ckpt.transfer_obs_width(
                trainer, ts, ckpt.load(args["transfer_checkpoint"]),
                int(args["transfer_old_obs_dim"]), task.num_obs)
        log_every = max(1, int(args.get("log_every")
                               or max(1, cfg.max_epochs // 50)))
        viz_every = int(self.params.get("config", {}).get(
            "viz_every_epochs", 0) or 0)
        cuda = trainer.device.type == "cuda"
        history = []
        best_reward = -1e9
        best_success = 0.0     # saved only once the task actually succeeds
        start = t_last = time.time()
        frames_since = 0
        epoch = ts.epoch
        try:
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
                writer.add_scalars(self.scalars(row, m), ts.frame)
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
                if viz_every and epoch % viz_every == 0:
                    self._dump_training_viz(task, trainer, ts, run_dir, epoch)
                if row["mean_reward"] > cfg.score_to_win:
                    break
        finally:
            writer.close()
        last = os.path.join(ck_dir, f"last_{name}")
        self.save(ts, last, history[-1]["mean_reward"] if history else -1e9)
        info = {"best_reward": best_reward, "epochs": epoch,
                "wall_time_s": time.time() - start, "run_dir": run_dir,
                "checkpoint": last + ".pt", "history": history}
        if task.has_success:
            info["best_success"] = best_success
        return ts, info

    @staticmethod
    def scalars(row: Dict[str, float], m: Dict[str, Any]) -> Dict[str, float]:
        """A logged epoch's scalars under the reference's tags."""
        out = {tag: row[k] for tag, k in TAGS.items() if k in row}
        out.update({k: float(v) for k, v in m.items()
                    if k.startswith("Episode/")})
        return out

    @staticmethod
    def _dump_training_viz(task, trainer, ts, run_dir: str, epoch: int,
                           steps: int = 200, k_rec: int = 4) -> None:
        """A short episode of the current policy on a fresh env batch
        (generator seeded with the epoch), dumped to run_dir/viz/
        epoch_%06d; the training env state is not touched."""
        from airgym_tpu_torch.utils.episode_viz import dump_episode
        rec = Player(task, trainer, ts).rollout(
            steps, seed=epoch, chunk=steps, record=True, record_envs=k_rec)
        dump_episode(os.path.join(run_dir, "viz", f"epoch_{epoch:06d}"),
                     rec)

    @staticmethod
    def save(ts, path_no_ext: str, mean_reward: float = -1e9) -> None:
        ckpt.save(path_no_ext + ".pt", ts)
        ckpt.export_pth(path_no_ext + ".pth", ts, mean_reward)


def restore(ts, path: str):
    """A native ``.pt`` or a reference ``.pth`` checkpoint into ``ts``."""
    if path.endswith(".pth"):
        return ckpt.restore_pth(ts, path)
    return ckpt.restore(ts, ckpt.load(path))


class Player:
    """Deterministic evaluator: the action is the policy's mean, clamped
    to [-1, 1] (reference players.py)."""

    def __init__(self, task, trainer: ppo_mod.PPO, ts=None):
        self.task = task
        self.trainer = trainer
        self.ts = trainer.init(0) if ts is None else ts

    def restore(self, path: str) -> None:
        self.ts = restore(self.ts, path)

    @torch.no_grad()
    def rollout(self, max_steps: int, seed: int = 0, chunk: int = 100,
                record: bool = False, record_envs: int = 4,
                games_num: int = 10 ** 9) -> Dict[str, np.ndarray]:
        """Boot a fresh env batch (``initial_state`` and one zero-action
        step, from a generator seeded with ``seed``), then run chunks of
        ``chunk`` steps, ``max(1, max_steps // chunk)`` at most, with one
        host copy per chunk; stop at the chunk boundary once
        ``games_num`` episodes have finished. Returns the host arrays
        "reward" and "reset" [T, N], "success" (success & reset) where the
        task emits it, and with ``record`` "root" [T, k, 13] of the first
        k envs and "camera" [T, W, H] of env 0 on camera tasks."""
        task, ts = self.task, self.ts
        dev = self.trainer.device
        n_rows = getattr(task, "flat_n", task.cfg.num_envs)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        env_state = task.initial_state(gen)
        env_state, out = task.step(
            env_state, torch.zeros((n_rows, task.cfg.num_actions),
                                   device=dev), gen)
        obs, rms = out.obs, self.trainer._rms(ts)
        k_rec = min(record_envs, n_rows)
        recs, done_games = [], 0
        for _ in range(max(1, max_steps // chunk)):
            steps = {}
            for _ in range(chunk):
                mu, _, _ = ts.model(obs, rms)
                env_state, out = task.step(env_state,
                                           torch.clamp(mu, -1.0, 1.0), gen)
                rec = {"reward": out.reward, "reset": out.reset}
                if "success" in out.info:
                    rec["success"] = out.info["success"] & out.reset
                if record:
                    core = getattr(env_state, "core", env_state)
                    rec["root"] = core.root[:k_rec, :13]
                    if hasattr(env_state, "camera"):
                        rec["camera"] = env_state.camera[0, 0]
                for k, v in rec.items():
                    steps.setdefault(k, []).append(v)
                obs = out.obs
            recs.append({k: torch.stack(v).cpu().numpy()
                         for k, v in steps.items()})
            done_games += int(recs[-1]["reset"].sum())
            if done_games >= games_num:
                break
        return {k: np.concatenate([r[k] for r in recs], 0) for k in recs[0]}

    def run(self, max_steps: int = 1000, seed: int = 0, chunk: int = 100,
            record_dir: Optional[str] = None, record_envs: int = 4,
            games_num: int = 10 ** 9) -> Dict[str, Any]:
        """Evaluate (``rollout``): the mean reward per finished episode,
        the games, the steps and, where the task emits success, the share
        of finished episodes that ended by it. With ``record_dir`` the
        episode of the first ``record_envs`` envs is dumped there
        (``utils/episode_viz.dump_episode``: needs matplotlib, and PIL on
        camera tasks)."""
        rec = self.rollout(max_steps, seed=seed, chunk=chunk,
                           record=record_dir is not None,
                           record_envs=record_envs, games_num=games_num)
        rewards, resets = rec["reward"], rec["reset"]
        games = max(1, int(resets.sum()))
        result = {"mean_reward": float(rewards.sum() / games),
                  "games": games, "steps": rewards.shape[0]}
        line = (f"av reward: {result['mean_reward']:.2f} games played: "
                f"{games}")
        if "success" in rec:
            result["success_rate"] = float(rec["success"].sum()) / games
            line += f" success_rate: {result['success_rate']:.3f}"
        print(line, flush=True)
        if record_dir is not None:
            from airgym_tpu_torch.utils.episode_viz import dump_episode
            dump_episode(record_dir, rec)
            print(f"episode visualization -> {record_dir}", flush=True)
        return result
