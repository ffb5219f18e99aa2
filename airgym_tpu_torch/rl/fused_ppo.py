"""PPO with the rollout and the update phase each in one fused kernel
(counterpart of airgym_tpu/rl/fused_ppo.py).

``FusedHoveringPPO`` runs the whole rollout through
``ops/fused_rollout.rollout_fused_policy`` (csrc/fused_rollout.cu) and the
whole update phase through ``ops/fused_update.fused_update``
(csrc/fused_update.cu); GAE, the running stats and the dataset stay plain
PyTorch (rl/ppo.py). On CPU tensors both ops run their plain versions.
``FusedBalloonPPO`` and ``FusedTrackingPPO`` change only the task hooks:
how the env state is packed and unpacked, the bootstrap observation and
the per-step success flags.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from airgym_tpu_torch.ops import fused_hovering as fh
from airgym_tpu_torch.ops import fused_rollout as fr
from airgym_tpu_torch.ops import fused_update as fu
from airgym_tpu_torch.physics import quadrotor as qd
from airgym_tpu_torch.rl import ppo as ppo_mod


class FusedHoveringPPO(ppo_mod.PPO):
    """Requirements: the trainer's task (``fused_task``), ctl_mode
    'rate', num_envs % 1024 == 0, the shared-trunk fixed-sigma
    [64,128,64] elu network."""

    fused_task = "hovering"

    def __init__(self, task, cfg=ppo_mod.PPOConfig(), network_kw=None):
        if task.task_name != self.fused_task or task.cfg.ctl_mode != "rate":
            raise NotImplementedError(
                f"{type(self).__name__} covers {self.fused_task} / rate "
                f"only, got {task.task_name} / {task.cfg.ctl_mode}: its "
                f"kernels run the rate cascade; other modes train with the "
                f"plain rl/ppo.PPO, as the runner picks it")
        if task.cfg.num_envs % fr.TILE:
            raise NotImplementedError(
                f"num_envs={task.cfg.num_envs} is not a multiple of "
                f"{fr.TILE}: other counts train with the plain rl/ppo.PPO "
                f"(ROADMAP.md queue A item 7b), as the runner picks it")
        net = dict(network_kw or {})
        if tuple(net.get("units", fr.UNITS)) != fr.UNITS \
                or net.get("activation", "elu") != "elu" \
                or net.get("separate") or not net.get("fixed_sigma", True):
            raise NotImplementedError(
                f"the fused kernels run the [64,128,64] elu shared-trunk "
                f"fixed-sigma net, got {net}: other nets train with the "
                f"plain rl/ppo.PPO (ROADMAP.md queue C, activations in the "
                f"fused trainer), as the runner picks it")
        self._motor_alpha = qd.motor_alpha(task.params)
        super().__init__(task, cfg, network_kw=network_kw)

    # -- task hooks (overridden by the Balloon and Tracking trainers) -------

    def _pack_env(self, env_state) -> torch.Tensor:
        return fh.pack_state(env_state.core)

    def _unpack_env(self, env_state, packed_out, core):
        return env_state._replace(core=core)

    def _last_obs(self, env_state, root, generator):
        return self.task.state_obs18(root, generator) - self.task.target

    def _fused_success(self, obs, rewards, dones) -> Optional[torch.Tensor]:
        """Per-step task-success flags [H, N], or None for a task without
        a success notion."""
        return None

    # -----------------------------------------------------------------------

    def rollout(self, ts: ppo_mod.TrainState, seed: Optional[int] = None):
        cfg = self.cfg
        if seed is None:
            seed = int(torch.randint(0, 2 ** 31 - 1, (1,),
                                     generator=ts.seed_generator))
        pack = fr.pack_policy(ts.model, ts.obs_rms)
        packed_out, rec = fr.rollout_fused_policy(
            self._pack_env(ts.env_state), pack, seed, cfg.horizon,
            obs_noise=self.task.cfg.obs_noise, task=self.fused_task,
            motor_alpha=self._motor_alpha)

        # unpack the trajectory record [H, OBS + 13, N]
        k = self.task.num_obs
        tp = lambda a: torch.transpose(a, 1, 2)           # -> [H, N, k]
        obs = tp(rec[:, 0:k])
        rewards = rec[:, k + 10]
        dones = rec[:, k + 11] > 0.5
        sigma = torch.exp(ts.model.logstd.detach())
        mus = tp(rec[:, k + 6:k + 10])
        traj = ppo_mod.Rollout(
            obs=obs, prenorm=obs, actions=tp(rec[:, k:k + 4]),
            neglogp=rec[:, k + 4], values=rec[:, k + 5], mus=mus,
            sigmas=sigma.expand(mus.shape), rewards=rewards, dones=dones,
            timeouts=rec[:, k + 12] > 0.5)

        successes = self._fused_success(obs, rewards, dones)
        if (successes is None) != (ts.last_ep_success is None):
            raise ValueError(
                f"{type(self).__name__}._fused_success and "
                f"{type(self.task).__name__}.has_success disagree")

        # episode bookkeeping
        ep_ret, ep_len = ts.ep_return, ts.ep_length
        last_ret, last_len = ts.last_ep_return, ts.last_ep_length
        last_suc = ts.last_ep_success
        for t in range(cfg.horizon):
            d = dones[t]
            ep_ret = ep_ret + rewards[t]
            ep_len = ep_len + 1.0
            last_ret = torch.where(d, ep_ret, last_ret)
            last_len = torch.where(d, ep_len, last_len)
            if last_suc is not None:
                last_suc = torch.where(d, successes[t].to(ep_ret.dtype),
                                       last_suc)
            alive = 1.0 - d.to(ep_ret.dtype)
            ep_ret, ep_len = ep_ret * alive, ep_len * alive

        # rebuild the env state (the vel-loop fields are untouched in rate)
        old = ts.env_state.core
        root = fh.unpack_root(packed_out)
        core = old._replace(
            root=root,
            ctrl=old.ctrl._replace(rate_int=packed_out[13:16].T,
                                   prev_rate=packed_out[16:19].T),
            progress=packed_out[19].to(torch.int32),
            reset_buf=packed_out[20] > 0.5,
            pre_actions=packed_out[21:25].T,
            rotors=(packed_out[25:29].T if old.rotors is not None else None))
        env_state = self._unpack_env(ts.env_state, packed_out, core)

        # bootstrap value from the post-rollout observation (GAE zeroes it
        # for done envs, so the post-reset state is never consumed)
        last_obs = self._last_obs(env_state, root, ts.generator)
        with torch.no_grad():
            _, _, last_value = ts.model(last_obs, ts.obs_rms)

        ts = dataclasses.replace(
            ts, env_state=env_state, obs=last_obs, ep_return=ep_ret,
            ep_length=ep_len, last_ep_return=last_ret,
            last_ep_length=last_len, last_ep_success=last_suc)
        return ts, traj, last_value[:, 0], {"reward": torch.mean(rewards)}

    def _can_fuse_update(self, dataset) -> bool:
        # the reference's rules minus its TPU VMEM cap on the batch size
        # (the net's shape is checked at construction)
        cfg = self.cfg
        return (not isinstance(dataset["obs"], dict)
                and not cfg.clip_value
                and not cfg.use_smooth_clamp
                and cfg.lr_schedule in ("adaptive", "fixed", "linear")
                and cfg.normalize_input
                and self.batch_size % self.num_minibatches == 0)

    def update(self, ts: ppo_mod.TrainState, dataset):
        if not self._can_fuse_update(dataset):
            return super().update(ts, dataset)
        cfg = self.cfg
        if cfg.lr_schedule == "linear":
            mul = max(0.0, 1.0 - ts.epoch / cfg.max_epochs)
            ts = dataclasses.replace(ts, lr=torch.tensor(
                max(cfg.min_lr, cfg.learning_rate * mul), dtype=torch.float32,
                device=self.device))

        obs_n = ts.obs_rms.normalize(dataset["obs"])
        params = dict(ts.model.named_parameters())
        kcfg = dict(e_clip=cfg.e_clip, critic_coef=cfg.critic_coef,
                    bounds_coef=cfg.bounds_loss_coef,
                    entropy_coef=cfg.entropy_coef,
                    truncate_grads=cfg.truncate_grads,
                    grad_norm=cfg.grad_norm,
                    adaptive_lr=cfg.lr_schedule == "adaptive",
                    kl_threshold=cfg.kl_threshold,
                    min_lr=cfg.min_lr, max_lr=cfg.max_lr)
        w2, m2, v2, lr2, t2, metrics = fu.fused_update(
            obs_n, dataset["actions"], dataset["adv"], dataset["returns"],
            dataset["neglogp"], dataset["mus_init"],
            dataset["sigmas_init"][0].reshape(-1, 1).contiguous(),
            fu.pack_update(params), fu.pack_update(ts.adam["m"]),
            fu.pack_update(ts.adam["v"]), ts.lr.reshape(1),
            ts.adam["count"].reshape(1), nmb=self.num_minibatches,
            mini_epochs=cfg.mini_epochs, cfg=kcfg)

        with torch.no_grad():
            for name, value in fu.unpack_update(w2).items():
                params[name].copy_(value)
        adam = {"m": fu.unpack_update(m2), "v": fu.unpack_update(v2),
                "count": t2}
        return dataclasses.replace(ts, adam=adam, lr=lr2[0]), metrics


class FusedBalloonPPO(FusedHoveringPPO):
    """Balloon (rate mode): the balloon position and pre_root_pos travel
    in rows 29:35 of the packed state, and the kernel applies the balloon
    reward, kill and reset rules."""

    fused_task = "balloon"

    def _pack_env(self, env_state):
        return fr.pack_state_balloon(env_state.core, env_state.balloon,
                                     env_state.pre_root_pos)

    def _unpack_env(self, env_state, packed_out, core):
        balloon = env_state.balloon.clone()
        balloon[:, 0:3] = packed_out[29:32].T
        return env_state._replace(core=core, balloon=balloon,
                                  pre_root_pos=packed_out[32:35].T)

    def _last_obs(self, env_state, root, generator):
        return self.task._observations(root, env_state.balloon, generator)

    def _fused_success(self, obs, rewards, dones):
        # the +800 hit bonus outweighs every other term (their sum stays
        # well under 40 in magnitude), so a step with reward > 400 is
        # exactly a hit; the record carries no separate flag
        return dones & (rewards > 400.0)


class FusedTrackingPPO(FusedHoveringPPO):
    """Tracking (rate mode): the kernel builds the 10-point lemniscate
    window from the progress counter, so the 48-dim observation is never
    stored between steps."""

    fused_task = "tracking"

    def _unpack_env(self, env_state, packed_out, core):
        pre = torch.where((packed_out[20] > 0.5)[:, None],
                          torch.zeros((), dtype=packed_out.dtype,
                                      device=packed_out.device),
                          packed_out[0:3].T)
        return env_state._replace(core=core, pre_root_pos=pre)

    def _last_obs(self, env_state, root, generator):
        return self.task.observations(root, env_state.core.progress,
                                      generator)[0]
