"""PPO with the rollout and the update phase each in one fused kernel
(counterpart of airgym_tpu/rl/fused_ppo.py).

``FusedHoveringPPO`` runs the whole rollout through
``ops/fused_rollout.rollout_fused_policy`` (csrc/fused_rollout.cu), GAE,
the running stats and the dataset through ``ops/epoch_prep.epoch_prep``
(csrc/epoch_prep.cu) and the whole update phase through
``ops/fused_update.fused_update`` (csrc/fused_update.cu). On CPU tensors
the rollout and update ops run their plain versions, and GAE, the stats
and the dataset stay rl/ppo.py's PyTorch. ``FusedBalloonPPO`` and
``FusedTrackingPPO`` change only the task hooks: how the env state is
packed and unpacked, the bootstrap observation and the per-step success
flags.

What runs is decided once, when the trainer is built: ``refusal`` is the
one rule of the tasks, modes, env counts and nets the kernels cover, which
``Runner.build`` and ``__init__`` both apply, and ``__init__`` sets
``update_kernel`` and ``prep_kernels`` from the config, ranks and device.

On several ranks (parallel/dist.py) each rank's rollout kernel runs its
block of the envs with the seed offset by its first tile, so the ranks'
rollouts are the one-GPU rollout's rows; the update then takes the plain
trainer's distributed update, as the JAX fused trainer takes its XLA
update under a mesh: the update kernel runs one GPU's Adam steps.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from airgym_tpu_torch.ops import epoch_prep as ep
from airgym_tpu_torch.ops import fused_hovering as fh
from airgym_tpu_torch.ops import fused_rollout as fr
from airgym_tpu_torch.ops import fused_update as fu
from airgym_tpu_torch.ops import hash_rng as hr
from airgym_tpu_torch.physics import quadrotor as qd
from airgym_tpu_torch.rl import ppo as ppo_mod
from airgym_tpu_torch.rl import profiling


class FusedHoveringPPO(ppo_mod.PPO):
    """The fused trainer of ``fused_task`` for the configs ``refusal``
    lets through."""

    fused_task = "hovering"

    @classmethod
    def refusal(cls, task, network_kw=None) -> Optional[str]:
        """None where the kernels cover ``task`` (on several ranks, this
        rank's block of the envs) and the net ``network_kw``, else why
        not: the task and ctl_mode 'rate', num_envs % 1024 == 0, the
        shared-trunk fixed-sigma [64,128,64] elu net."""
        if task.task_name != cls.fused_task or task.cfg.ctl_mode != "rate":
            return (f"{cls.__name__} covers {cls.fused_task} / rate only, "
                    f"got {task.task_name} / {task.cfg.ctl_mode}: its "
                    f"kernels run the rate cascade")
        if task.cfg.num_envs % fr.TILE:
            return (f"num_envs={task.cfg.num_envs} is not a multiple of "
                    f"{fr.TILE} (ROADMAP.md queue F item 3)")
        net = dict(network_kw or {})
        if tuple(net.get("units", fr.UNITS)) != fr.UNITS \
                or net.get("activation", "elu") != "elu" \
                or net.get("separate") or not net.get("fixed_sigma", True):
            return (f"the fused kernels run the [64,128,64] elu shared-trunk "
                    f"fixed-sigma net, got {net} (ROADMAP.md queue F item "
                    f"3)")
        return None

    def __init__(self, task, cfg=ppo_mod.PPOConfig(), network_kw=None,
                 group=None, shares=None):
        reason = self.refusal(task, network_kw)
        if reason is not None:
            raise NotImplementedError(
                f"{reason}; other configs train with the plain rl/ppo.PPO, "
                f"as the runner picks it")
        self._motor_alpha = qd.motor_alpha(task.params)
        # the last rollout's record [H, OBS + 13, N], of which its Rollout
        # fields are views: _prepare's kernels read it in place
        self._record: Optional[torch.Tensor] = None
        super().__init__(task, cfg, network_kw=network_kw, group=group,
                         shares=shares)
        # the reference's rules minus its TPU VMEM cap on the batch size; a
        # multi-rank run and its one-process witness take the plain update
        self.update_kernel = (self.world == 1 and not self.witness
                              and not cfg.clip_value
                              and not cfg.use_smooth_clamp
                              and cfg.lr_schedule in ("adaptive", "fixed",
                                                      "linear")
                              and cfg.normalize_input)
        # GAE, the stats and the dataset as csrc/epoch_prep.cu where the
        # update kernel runs, with every normalisation the kernels apply
        # (the bootstrap on time-outs is their flag), on the card; the CPU
        # keeps rl/ppo.py's PyTorch, whose float32 advantage mean and std
        # are the frozen reference's (portbench/reference) bit for bit
        self.prep_kernels = (self.update_kernel and cfg.normalize_value
                             and cfg.normalize_advantage
                             and not cfg.normalize_rms_advantage
                             and torch.device(self.device).type == "cuda")
        self._kcfg = dict(e_clip=cfg.e_clip, critic_coef=cfg.critic_coef,
                          bounds_coef=cfg.bounds_loss_coef,
                          entropy_coef=cfg.entropy_coef,
                          truncate_grads=cfg.truncate_grads,
                          grad_norm=cfg.grad_norm,
                          adaptive_lr=cfg.lr_schedule == "adaptive",
                          kl_threshold=cfg.kl_threshold,
                          min_lr=cfg.min_lr, max_lr=cfg.max_lr)

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

    def _rank_seed(self, seed: int) -> int:
        """The kernel seeds each 1024-env tile as seed + tile *
        0x01000193 from the env's index in its own launch
        (csrc/common.cuh tile_seed); offset by this rank's first tile,
        the tiles draw what they draw in the whole batch's launch."""
        first_tile = self.rank * (self.num_envs // fr.TILE)
        return (int(seed) + hr.mulmod(first_tile, 0x01000193)) & hr.M32

    # -----------------------------------------------------------------------

    def rollout(self, ts: ppo_mod.TrainState, seed: Optional[int] = None):
        cfg = self.cfg
        if seed is None:
            seed = int(torch.randint(0, 2 ** 31 - 1, (1,),
                                     generator=ts.seed_generator))
        pack = fr.pack_policy(ts.model, ts.obs_rms)
        packed_out, rec = fr.rollout_fused_policy(
            self._pack_env(ts.env_state), pack, self._rank_seed(seed),
            cfg.horizon,
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
        self._record = rec if self.prep_kernels else None

        successes = self._fused_success(obs, rewards, dones)
        if (successes is None) != (ts.last_ep_success is None):
            raise ValueError(
                f"{type(self).__name__}._fused_success and "
                f"{type(self.task).__name__}.has_success disagree")

        # episode bookkeeping and the env-state rebuild
        with profiling.span("bookkeeping"):
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

            # rebuild the env state (the vel-loop fields are untouched in
            # rate)
            old = ts.env_state.core
            root = fh.unpack_root(packed_out)
            core = old._replace(
                root=root,
                ctrl=old.ctrl._replace(rate_int=packed_out[13:16].T,
                                       prev_rate=packed_out[16:19].T),
                progress=packed_out[19].to(torch.int32),
                reset_buf=packed_out[20] > 0.5,
                pre_actions=packed_out[21:25].T,
                rotors=(packed_out[25:29].T if old.rotors is not None
                        else None))
            env_state = self._unpack_env(ts.env_state, packed_out, core)

        # bootstrap value from the post-rollout observation (GAE zeroes it
        # for done envs, so the post-reset state is never consumed)
        last_obs = self._last_obs(env_state, root, ts.generator)
        with torch.no_grad():
            _, _, last_value = self._by_rank(
                lambda o: ts.model(o, ts.obs_rms), last_obs)

        ts = dataclasses.replace(
            ts, env_state=env_state, obs=last_obs, ep_return=ep_ret,
            ep_length=ep_len, last_ep_return=last_ret,
            last_ep_length=last_len, last_ep_success=last_suc)
        return ts, traj, last_value[:, 0], {"reward": torch.mean(rewards)}

    def _prepare(self, ts: ppo_mod.TrainState, traj, last_value):
        if not self.prep_kernels:
            return super()._prepare(ts, traj, last_value)
        rec, self._record = self._record, None
        if rec is None:
            raise RuntimeError(
                f"{type(self).__name__}: no rollout record to prepare the "
                f"epoch from; the kernels read the record of the rollout "
                f"just run")
        cfg = self.cfg
        p = ep.epoch_prep(rec, last_value, ts.obs_rms, ts.value_rms,
                          gamma=cfg.gamma, tau=cfg.tau,
                          reward_scale=cfg.reward_shaper_scale,
                          value_bootstrap=cfg.value_bootstrap)
        with profiling.span("dataset"):
            ts = dataclasses.replace(ts, obs_rms=p.obs_rms,
                                     value_rms=p.value_rms)
            dataset = {"obs": p.obs_n, "actions": p.actions,
                       "neglogp": p.neglogp, "adv": p.adv_n,
                       "returns": p.returns_n, "mus_init": p.mus,
                       "sigmas_init": traj.sigmas[0, 0].expand(
                           self.batch_size, -1)}
        return ts, p.values, p.returns, dataset

    def _dataset(self, ts, traj, values_m, returns_m, adv):
        dataset = super()._dataset(ts, traj, values_m, returns_m, adv)
        if self.update_kernel:
            # the update kernel takes the normalised observations
            dataset["obs"] = ts.obs_rms.normalize(dataset["obs"])
        return dataset

    def update(self, ts: ppo_mod.TrainState, dataset):
        """The update kernel on the dataset of ``_prepare``, whose "obs"
        are normalised where it runs; else the plain update."""
        if not self.update_kernel:
            return super().update(ts, dataset)
        ts = self._scheduled_lr(ts)
        params = dict(ts.model.named_parameters())
        w2, m2, v2, lr2, t2, metrics = fu.fused_update(
            dataset["obs"], dataset["actions"], dataset["adv"],
            dataset["returns"], dataset["neglogp"], dataset["mus_init"],
            dataset["sigmas_init"][0].reshape(-1, 1).contiguous(),
            fu.pack_update(params), fu.pack_update(ts.adam["m"]),
            fu.pack_update(ts.adam["v"]), ts.lr.reshape(1),
            ts.adam["count"].reshape(1), nmb=self.num_minibatches,
            mini_epochs=self.cfg.mini_epochs, cfg=self._kcfg)

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


FUSED_TRAINERS = {"hovering": FusedHoveringPPO, "balloon": FusedBalloonPPO,
                  "tracking": FusedTrackingPPO}
