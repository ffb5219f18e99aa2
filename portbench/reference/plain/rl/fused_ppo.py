"""PPO for Hovering with the rollout and the update phase each in one call
of a fused kernel's plain version.

``FusedHoveringPPO`` runs the whole rollout through
``ops/fused_rollout.rollout_fused_policy`` (the plain version of
csrc/fused_rollout.cu) and the whole update phase through
``ops/fused_update.fused_update`` (csrc/fused_update.cu); GAE, the running
stats and the dataset are rl/ppo.py's.
"""
from __future__ import annotations

import dataclasses

import torch

from portbench.reference.plain.ops import fused_hovering as fh
from portbench.reference.plain.ops import fused_rollout as fr
from portbench.reference.plain.ops import fused_update as fu
from portbench.reference.plain.rl import ppo as ppo_mod


class FusedHoveringPPO(ppo_mod.PPO):
    """Requirements: the Hovering task in rate mode, num_envs % 1024 == 0
    (``reference/train.build`` checks them)."""

    fused_task = "hovering"     # as the program's fused trainer names it

    def rollout(self, ts: ppo_mod.TrainState):
        cfg = self.cfg
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,),
                                 generator=ts.seed_generator))
        packed_out, rec = fr.rollout_fused_policy(
            fh.pack_state(ts.env_state.core),
            fr.pack_policy(ts.model, ts.obs_rms), seed, cfg.horizon,
            obs_noise=self.task.cfg.obs_noise)

        # unpack the trajectory record [H, OBS + 13, N]
        k = self.task.num_obs
        tp = lambda a: torch.transpose(a, 1, 2)           # -> [H, N, k]
        obs = tp(rec[:, 0:k])
        sigma = torch.exp(ts.model.logstd.detach())
        mus = tp(rec[:, k + 6:k + 10])
        traj = ppo_mod.Rollout(
            obs=obs, prenorm=obs, actions=tp(rec[:, k:k + 4]),
            neglogp=rec[:, k + 4], values=rec[:, k + 5], mus=mus,
            sigmas=sigma.expand(mus.shape), rewards=rec[:, k + 10],
            dones=rec[:, k + 11] > 0.5, timeouts=rec[:, k + 12] > 0.5)

        # rebuild the env state (the vel-loop fields are untouched in rate)
        old = ts.env_state.core
        root = packed_out[0:13].T
        core = old._replace(
            root=root,
            ctrl=old.ctrl._replace(rate_int=packed_out[13:16].T,
                                   prev_rate=packed_out[16:19].T),
            progress=packed_out[19].to(torch.int32),
            reset_buf=packed_out[20] > 0.5,
            pre_actions=packed_out[21:25].T,
            rotors=packed_out[25:29].T)
        env_state = ts.env_state._replace(core=core)

        # bootstrap value from the post-rollout observation (GAE zeroes it
        # for done envs, so the post-reset state is never consumed)
        last_obs = self.task.state_obs18(root, ts.generator) - self.task.target
        with torch.no_grad():
            _, _, last_value = ts.model(last_obs, ts.obs_rms)
        ts = dataclasses.replace(ts, env_state=env_state, obs=last_obs)
        return ts, traj, last_value[:, 0]

    def update(self, ts: ppo_mod.TrainState, dataset):
        cfg = self.cfg
        obs_n = ts.obs_rms.normalize(dataset["obs"])
        params = dict(ts.model.named_parameters())
        kcfg = dict(e_clip=cfg.e_clip, critic_coef=cfg.critic_coef,
                    bounds_coef=cfg.bounds_loss_coef,
                    entropy_coef=cfg.entropy_coef, grad_norm=cfg.grad_norm,
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
