"""PPO trainer core (counterpart of airgym_tpu/rl/ppo.py).

One ``train_epoch`` = the rollout, GAE with the reference's discount,
reward shaping and value bootstrap on time-outs, the running-stat
updates, advantage normalization, the env-major flattening into
contiguous minibatches (no shuffle, as the reference's PPODataset), and
the update phase.

This slice ports what the fused Hovering trainer (``rl/fused_ppo.py``)
runs: ``PPO.init``, ``compute_gae`` and ``train_epoch``. The scan rollout
and the non-fused minibatch update are ROADMAP.md queue A item 7b and
raise until then.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch

from airgym_tpu_torch.models import actor_critic as ac
from airgym_tpu_torch.rl.running_stats import RunningMeanStd


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Hyperparameters; defaults = ppo_hovering.yaml."""
    horizon: int = 24
    minibatch_size: int = 2048
    mini_epochs: int = 5
    gamma: float = 0.99
    tau: float = 0.95
    learning_rate: float = 3e-4
    lr_schedule: str = "adaptive"          # adaptive | fixed | linear
    kl_threshold: float = 0.008
    min_lr: float = 1e-6
    max_lr: float = 1e-2
    e_clip: float = 0.2
    use_smooth_clamp: bool = False
    clip_value: bool = False
    critic_coef: float = 2.0
    entropy_coef: float = 0.0
    bounds_loss_coef: float = 1e-4
    grad_norm: float = 1.5
    truncate_grads: bool = True
    normalize_input: bool = True
    normalize_value: bool = True
    normalize_advantage: bool = True
    normalize_rms_advantage: bool = False
    value_bootstrap: bool = True
    reward_shaper_scale: float = 0.1
    max_epochs: int = 200
    save_frequency: int = 100
    save_best_after: int = 10
    score_to_win: float = 1e5


@dataclasses.dataclass
class TrainState:
    """Everything a train epoch reads and writes. ``model`` holds the
    parameters (updated in place); ``adam`` holds the moments under the
    parameter names and the shared step count; ``generator`` draws the
    env's noise and resets on its device, ``seed_generator`` (CPU) draws
    the rollout kernel's int32 seeds without a device sync."""
    model: ac.ActorCritic
    adam: Dict[str, Any]
    obs_rms: RunningMeanStd
    value_rms: Optional[RunningMeanStd]
    env_state: Any
    obs: torch.Tensor               # last raw obs [N, obs]
    lr: torch.Tensor                # 0-d float32, adapted by KL
    epoch: int
    frame: int
    ep_return: torch.Tensor         # [N] running episodic return
    ep_length: torch.Tensor
    last_ep_return: torch.Tensor    # [N] return of the last finished episode
    last_ep_length: torch.Tensor
    generator: torch.Generator
    seed_generator: torch.Generator
    # [N] 1.0 iff the last finished episode ended by task success (tasks
    # with has_success, e.g. Balloon's hit); None otherwise
    last_ep_success: Optional[torch.Tensor] = None


class Rollout(NamedTuple):
    obs: torch.Tensor               # [H, N, obs] raw
    prenorm: torch.Tensor           # pre-normalization MLP input
    actions: torch.Tensor
    neglogp: torch.Tensor
    values: torch.Tensor            # normalized (model-space) values
    mus: torch.Tensor
    sigmas: torch.Tensor
    rewards: torch.Tensor
    dones: torch.Tensor
    timeouts: torch.Tensor


def adam_init(model: ac.ActorCritic) -> Dict[str, Any]:
    p = dict(model.named_parameters())
    return {"m": {k: torch.zeros_like(v.detach()) for k, v in p.items()},
            "v": {k: torch.zeros_like(v.detach()) for k, v in p.items()},
            "count": torch.zeros(1, dtype=torch.float32,
                                 device=next(iter(p.values())).device)}


class PPO:
    """Binds a functional task and the actor-critic into train epochs."""

    def __init__(self, task, cfg: PPOConfig = PPOConfig(),
                 network_kw: Optional[dict] = None):
        self.task = task
        self.cfg = cfg
        self.device = task.device
        self.num_envs = task.cfg.num_envs
        self.num_actions = task.cfg.num_actions
        self.network_kw = dict(network_kw or {})
        self.batch_size = self.num_envs * cfg.horizon
        self._minibatch_error = None
        if cfg.minibatch_size > self.batch_size:
            self._minibatch_error = (
                f"minibatch_size ({cfg.minibatch_size}) exceeds the rollout "
                f"batch ({self.num_envs} envs x {cfg.horizon} horizon = "
                f"{self.batch_size})")
        self.num_minibatches = max(1, self.batch_size // cfg.minibatch_size)
        if self.batch_size % self.num_minibatches:
            self._minibatch_error = (
                f"minibatch_size ({cfg.minibatch_size}) must divide the "
                f"rollout batch ({self.batch_size}) into equal minibatches")

    def make_model(self, generator: Optional[torch.Generator] = None):
        return ac.ActorCritic(self.task.num_obs, self.num_actions,
                              generator=generator,
                              **self.network_kw).to(self.device)

    def init(self, seed: int) -> TrainState:
        dev, n = self.device, self.num_envs
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        seed_gen = torch.Generator()
        seed_gen.manual_seed(seed)
        # reset() semantics: zero-action step to get the first obs
        env_state = self.task.initial_state(gen)
        env_state, out0 = self.task.step(
            env_state, torch.zeros((n, self.num_actions), device=dev), gen)
        model = self.make_model(seed_gen)
        zeros = lambda: torch.zeros((n,), dtype=torch.float32, device=dev)
        return TrainState(
            model=model, adam=adam_init(model),
            obs_rms=RunningMeanStd.create((self.task.num_obs,), dev),
            value_rms=(RunningMeanStd.create((), dev)
                       if self.cfg.normalize_value else None),
            env_state=env_state, obs=out0.obs,
            lr=torch.tensor(self.cfg.learning_rate, dtype=torch.float32,
                            device=dev),
            epoch=0, frame=0, ep_return=zeros(), ep_length=zeros(),
            last_ep_return=zeros(), last_ep_length=zeros(),
            generator=gen, seed_generator=seed_gen,
            last_ep_success=(zeros() if self.task.has_success else None))

    # ---------------------------------------------------------------- phases

    def rollout(self, ts: TrainState, seed: Optional[int] = None):
        raise NotImplementedError(
            "the scan (non-fused) rollout is not ported yet: ROADMAP.md "
            "queue A item 7b")

    def update(self, ts: TrainState, dataset: Dict[str, torch.Tensor]):
        raise NotImplementedError(
            "the non-fused minibatch update is not ported yet: ROADMAP.md "
            "queue A item 7b")

    def compute_gae(self, ts: TrainState, traj: Rollout, last_value):
        cfg = self.cfg
        denorm = (ts.value_rms.denormalize if cfg.normalize_value
                  else (lambda v: v))
        values = denorm(traj.values)            # [H, N]
        last_v = denorm(last_value)             # [N]
        rew = traj.rewards * cfg.reward_shaper_scale
        if cfg.value_bootstrap:
            # bootstrap with V(s_t) on time-outs
            rew = rew + cfg.gamma * values * traj.timeouts.to(rew.dtype)
        nonterminal = 1.0 - traj.dones.to(rew.dtype)
        adv = torch.empty_like(rew)
        lastgaelam = torch.zeros_like(last_v)
        next_value = last_v
        for t in reversed(range(rew.shape[0])):
            nt = nonterminal[t]
            delta = rew[t] + cfg.gamma * next_value * nt - values[t]
            lastgaelam = delta + cfg.gamma * cfg.tau * nt * lastgaelam
            adv[t] = lastgaelam
            next_value = values[t]
        return values, adv, adv + values

    def train_epoch(self, ts: TrainState, seed: Optional[int] = None):
        """Rollout + GAE + dataset + update. ``seed`` fixes the rollout
        kernel's int32 seed (tests use it to replay the JAX side's)."""
        if self._minibatch_error:
            raise ValueError(self._minibatch_error)
        cfg = self.cfg
        ts, traj, last_value, infos = self.rollout(ts, seed=seed)
        values, adv, returns = self.compute_gae(ts, traj, last_value)

        if cfg.normalize_input:
            ts = dataclasses.replace(ts,
                                     obs_rms=ts.obs_rms.update(traj.prenorm))
        if cfg.normalize_value:
            vr = ts.value_rms.update(values).update(returns)
            ts = dataclasses.replace(ts, value_rms=vr)
            values_m, returns_m = vr.normalize(values), vr.normalize(returns)
        else:
            values_m, returns_m = values, returns
        if cfg.normalize_rms_advantage:
            raise NotImplementedError(
                "normalize_rms_advantage is not ported yet: ROADMAP.md "
                "queue A item 6b (moving stats)")
        if cfg.normalize_advantage:
            adv = (adv - torch.mean(adv)) / (torch.std(adv, unbiased=False)
                                             + 1e-8)

        # [H, N, ...] -> env-major [N*H, ...]: contiguous minibatches group
        # whole trajectories like the reference's PPODataset
        def flat(x):
            x = torch.transpose(x, 0, 1)
            return x.reshape((self.batch_size,) + x.shape[2:]).contiguous()

        dataset = {
            "obs": flat(traj.obs), "actions": flat(traj.actions),
            "neglogp": flat(traj.neglogp), "values": flat(values_m),
            "returns": flat(returns_m), "adv": flat(adv),
            "mus_init": flat(traj.mus), "sigmas_init": flat(traj.sigmas),
        }
        ts, metrics = self.update(ts, dataset)
        ts = dataclasses.replace(ts, epoch=ts.epoch + 1,
                                 frame=ts.frame + self.batch_size)
        metrics = dict(metrics)
        metrics["lr"] = ts.lr
        metrics["mean_reward"] = torch.mean(ts.last_ep_return)
        metrics["mean_ep_length"] = torch.mean(ts.last_ep_length)
        metrics["reward_raw_per_step"] = torch.mean(traj.rewards)
        if ts.last_ep_success is not None:
            # share of the last finished episodes that ended in success
            metrics["success_rate"] = torch.mean(ts.last_ep_success)
        var_ret = torch.var(returns, unbiased=False)
        metrics["explained_variance"] = 1.0 - torch.var(
            returns - values, unbiased=False) / (var_ret + 1e-8)
        for k, v in infos.items():
            metrics[f"Episode/{k}"] = torch.mean(v)
        return ts, metrics
