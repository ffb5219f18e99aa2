"""PPO trainer (counterpart of airgym_tpu/rl/ppo.py).

One ``train_epoch`` = the rollout, GAE with the reference's discount,
reward shaping and value bootstrap on time-outs, the running-stat
updates, advantage normalization, the env-major flattening into
contiguous minibatches (no shuffle, as the reference's PPODataset), and
the update phase.

``PPO`` is the plain trainer every config can use: a Python loop over
the horizon (policy forward, Gaussian sample, env step) and an autograd
minibatch update with the reference's global-norm scale
``min(1, g / max(|grads|, 1e-6))`` (not ``clip_grad_norm_``) and optax's
Adam (eps outside the square root, lr folded in after the bias-corrected
step, one shared step count). ``rl/fused_ppo.py`` replaces the rollout and
the update with kernels for the configs they cover.

Adam steps the trainable parameters (``trainable``): the frozen VAE
encoder and ResNet-18 backbone stay out, as JAX's Adam leaves them
unchanged behind ``stop_gradient``.

Camera tasks (dict obs) add frame dedup: the camera renders every
``cam_every`` steps, ``init`` phase-aligns the render cadence to the
rollout's blocks, the rollout renders on the last step of each block
(a static ``render`` flag) and encodes each new frame once with the
model's encoder (CNN, VAE or ResNet-18), and stores
only the unique frames, in bfloat16. Minibatches gather their
(frame, env) pairs from a window of envs (``unique_window``); without
dedup the per-step images stay in rollout layout [H, N, ...] and each
minibatch cuts its window out of them (``_mb_from_scan_layout``).
Where the encoder is frozen but for a trained head it declares
(``ActorCritic.frozen_head``: ResNet-18's ``fc``, the VAE's identity),
the input of the head is the same for a window in every mini-epoch, so
``update`` keeps it from the first and the later ones run the head alone
on it (``ActorCritic.encode_head``, the ``encode_hit`` span).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch

from airgym_tpu_torch.models import actor_critic as ac
from airgym_tpu_torch.parallel import dist as pdist
from airgym_tpu_torch.rl import losses
from airgym_tpu_torch.rl import moving_stats as mstats
from airgym_tpu_torch.rl import profiling
from airgym_tpu_torch.rl import schedulers
from airgym_tpu_torch.rl.running_stats import RunningMeanStd

B1, B2, EPS = 0.9, 0.999, 1e-8
# decay of the moving advantage stats (the JAX config's default)
RMS_ADVANTAGE_DECAY = 0.995
METRICS = ("loss", "kl", "a_loss", "c_loss", "b_loss", "entropy",
           "clip_frac")


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
    # moving-stats advantage normalization (reference a2c_base.py:277-279);
    # overrides the per-batch normalization when on
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
    env's noise, resets and the policy's samples on its device,
    ``seed_generator`` (CPU) draws the rollout kernel's int32 seeds
    without a device sync. ``obs_rms`` is a dict {'image',
    'observation'} for camera tasks."""
    model: ac.ActorCritic
    adam: Dict[str, Any]
    obs_rms: Any
    value_rms: Optional[RunningMeanStd]
    env_state: Any
    obs: Any                        # last raw obs [N, obs] or dict
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
    # with has_success: Balloon's hit, Planning's goal); None otherwise
    last_ep_success: Optional[torch.Tensor] = None
    adv_ms: Optional[mstats.MovingStats] = None
    # [N] 1.0 iff the last finished env-level episode ended by env success
    # (tasks with has_env_success: MAPlanning, where any robot's goal
    # reach wins and any robot's event resets the whole env); None
    # otherwise
    last_ep_env_success: Optional[torch.Tensor] = None


class Rollout(NamedTuple):
    obs: Any                        # [H, N, obs] raw, or a dict of them
    prenorm: torch.Tensor           # pre-normalization MLP input
    actions: torch.Tensor
    neglogp: torch.Tensor
    values: torch.Tensor            # normalized (model-space) values
    mus: torch.Tensor
    sigmas: torch.Tensor
    rewards: torch.Tensor
    dones: torch.Tensor
    timeouts: torch.Tensor
    # frame dedup: which unique frame each step observed [H], and the
    # unique frames [F, N, 1, W, H]
    frame_idx: Optional[torch.Tensor] = None
    frames: Optional[torch.Tensor] = None


def trainable(model: ac.ActorCritic) -> Dict[str, torch.Tensor]:
    """The parameters Adam steps: all but the frozen encoder parts, which
    JAX's Adam leaves unchanged (zero gradients behind stop_gradient)."""
    return {k: p for k, p in model.named_parameters() if p.requires_grad}


def adam_init(model: ac.ActorCritic) -> Dict[str, Any]:
    p = trainable(model)
    return {"m": {k: torch.zeros_like(v.detach()) for k, v in p.items()},
            "v": {k: torch.zeros_like(v.detach()) for k, v in p.items()},
            "count": torch.zeros(1, dtype=torch.float32,
                                 device=next(iter(p.values())).device)}


def adam_step(params, grads, m, v, count, lr) -> None:
    """One optax Adam step in place: m, v the moments; ``count`` [1] the
    shared step count (incremented); lr a 0-d tensor."""
    count += 1.0
    t = count.reshape(())
    torch._foreach_mul_(m, B1)
    torch._foreach_add_(m, grads, alpha=1.0 - B1)
    torch._foreach_mul_(v, B2)
    torch._foreach_addcmul_(v, grads, grads, value=1.0 - B2)
    m_hat = torch._foreach_div(m, 1.0 - torch.pow(B1, t))
    denom = torch._foreach_div(v, 1.0 - torch.pow(B2, t))
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, EPS)
    torch._foreach_div_(m_hat, denom)
    torch._foreach_mul_(m_hat, lr)
    torch._foreach_sub_(params, m_hat)


def policy_kl(mu0, sigma0, mu1, sigma1):
    """Mean KL(N(mu0, s0) || N(mu1, s1)) (reference torch_ext.policy_kl)."""
    c = (torch.log(sigma1 / sigma0 + 1e-7)
         + (torch.square(sigma0) + torch.square(mu1 - mu0))
         / (2.0 * torch.square(sigma1) + 1e-7) - 0.5)
    return torch.mean(torch.sum(c, dim=-1))


class PPO:
    """Binds a functional task and the actor-critic into train epochs."""

    def __init__(self, task, cfg: PPOConfig = PPOConfig(),
                 network_kw: Optional[dict] = None,
                 group: Optional[pdist.Group] = None,
                 shares: Optional[int] = None):
        self.task = task
        self.cfg = cfg
        self.device = task.device
        # actors: the envs, or envs x robots for a task that flattens its
        # robot axis (MAPlanning's flat_n); on several ranks, this rank's
        self.num_envs = getattr(task, "flat_n", task.cfg.num_envs)
        self.num_actions = task.cfg.num_actions
        self.network_kw = dict(network_kw or {})
        # the ranks of a multi-GPU run (parallel/dist.py): each steps its
        # contiguous block of the envs, and the update runs on the batch
        # of all of them
        self.group = group
        self.world = group.world if group is not None else 1
        self.rank = group.rank if group is not None else 0
        if self.world > 1:
            want = (self.rank * task.cfg.num_envs,
                    self.world * task.cfg.num_envs)
            if task.shard != want:
                raise ValueError(
                    f"rank {self.rank} of {self.world} steps envs from "
                    f"{want[0]} of {want[1]}: set task.shard = {want} "
                    f"(parallel/dist.env_shard), got {task.shard}")
        # ``shares`` = n makes one process the witness of an n-rank run:
        # its rollout runs the model on the n ranks' blocks of envs
        # (``_by_rank``), and its plain update takes every minibatch in
        # the n ranks' shares and sums their gradients in rank order, so
        # that it differs from the ranks only where the all-reduce adds
        # in another order (for two ranks, nowhere)
        if shares is not None and group is not None:
            raise ValueError("shares makes one process the witness of a "
                             "multi-rank run; a rank takes its group's")
        if shares is not None and self.num_envs % int(shares):
            raise ValueError(f"{self.num_envs} envs do not split into "
                             f"{shares} ranks' blocks")
        self.witness = shares is not None
        self.shares = self.world if shares is None else int(shares)
        self.batch_envs = self.num_envs * self.world
        self.batch_size = self.batch_envs * cfg.horizon
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
        elif (self.batch_size // self.num_minibatches) % self.shares:
            self._minibatch_error = (
                f"a minibatch of {self.batch_size // self.num_minibatches} "
                f"samples does not split evenly over {self.shares} ranks")
        self.obs_is_dict = bool(getattr(task, "obs_is_dict", False))
        if self.obs_is_dict and self.network_kw.get("image_encoder") is None:
            # the JAX model encodes a dict obs's image with the CNN unless
            # another encoder is configured
            self.network_kw["image_encoder"] = "cnn"
        self.cam_every = task.cfg.cam_every
        # exact only when cam_every divides the horizon: every rollout then
        # holds horizon / cam_every renders whatever the counter's phase
        self.frame_dedup = (self.obs_is_dict and self.cam_every > 1
                            and cfg.horizon % self.cam_every == 0)
        self.num_frames = cfg.horizon // self.cam_every + 1

    def make_model(self, generator: Optional[torch.Generator] = None):
        return ac.ActorCritic(self.task.num_obs, self.num_actions,
                              generator=generator,
                              **self.network_kw).to(self.device)

    def _rms(self, ts: TrainState):
        return ts.obs_rms if self.cfg.normalize_input else None

    def _step_env(self, env_state, actions, generator, render=None):
        if render is None:
            return self.task.step(env_state, actions, generator)
        return self.task.step(env_state, actions, generator, render=render)

    def init(self, seed: int) -> TrainState:
        dev, n = self.device, self.num_envs
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        seed_gen = torch.Generator()
        seed_gen.manual_seed(seed)
        # reset() semantics: zero-action step to get the first obs
        zero = torch.zeros((n, self.num_actions), device=dev)
        env_state = self.task.initial_state(gen)
        env_state, out0 = self.task.step(env_state, zero, gen)
        if self.frame_dedup:
            # phase-align the render cadence to the rollout blocks: with
            # counter % cam_every == 0 at a rollout's start, each render
            # lands on the last step of a cam_every block
            for _ in range(self.cam_every - 1):
                env_state, out0 = self.task.step(env_state, zero, gen)
        model = self.make_model(seed_gen)
        if self.obs_is_dict:
            obs_rms = {
                "image": RunningMeanStd.create(out0.obs["image"].shape[1:],
                                               dev),
                "observation": RunningMeanStd.create(
                    (self.task.num_obs + model.image_features,), dev)}
        else:
            obs_rms = RunningMeanStd.create((self.task.num_obs,), dev)
        zeros = lambda: torch.zeros((n,), dtype=torch.float32, device=dev)
        return TrainState(
            model=model, adam=adam_init(model), obs_rms=obs_rms,
            value_rms=(RunningMeanStd.create((), dev)
                       if self.cfg.normalize_value else None),
            env_state=env_state, obs=out0.obs,
            lr=torch.tensor(self.cfg.learning_rate, dtype=torch.float32,
                            device=dev),
            epoch=0, frame=0, ep_return=zeros(), ep_length=zeros(),
            last_ep_return=zeros(), last_ep_length=zeros(),
            generator=gen, seed_generator=seed_gen,
            last_ep_success=(zeros() if self.task.has_success else None),
            adv_ms=(mstats.MovingStats.create((), dev)
                    if self.cfg.normalize_rms_advantage else None),
            last_ep_env_success=(zeros() if getattr(
                self.task, "has_env_success", False) else None))

    # ---------------------------------------------------------------- rollout

    def _by_rank(self, fn, obs):
        """``fn(obs)`` on the rollout's batch; the witness of an n-rank
        run (``shares``) applies it to the n ranks' blocks of envs and
        concatenates, as a GEMM may round otherwise at another batch
        size (on an H100 the actor's mean of 4096 rows is not bitwise
        its two halves' of 2048)."""
        if self.shares == 1 or not self.witness:
            return fn(obs)
        n = self.num_envs // self.shares
        rows = lambda x, r: ({k: v[r * n:(r + 1) * n] for k, v in x.items()}
                             if isinstance(x, dict) else x[r * n:(r + 1) * n])
        outs = [fn(rows(obs, r)) for r in range(self.shares)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(o) for o in zip(*outs))
        return torch.cat(outs)

    def _policy(self, ts: TrainState, obs, generator):
        mu, sigma, value, prenorm = self._by_rank(
            lambda o: ts.model(o, self._rms(ts), return_prenorm=True), obs)
        action = mu + sigma * self.task.randn(generator, *mu.shape,
                                              dtype=mu.dtype)
        nlp = ac.neglogp(action, mu, sigma, torch.log(sigma))
        return action, nlp, mu, sigma, value[..., 0], prenorm

    def _check_phase(self, env_state) -> None:
        """Frame dedup needs the render cadence aligned to the rollout
        blocks (``init`` aligns it; epochs keep it since cam_every divides
        the horizon); a misaligned state would make the block-cached
        features lag the camera."""
        c = int(env_state.counter)
        if c % self.cam_every:
            raise ValueError(
                f"frame-dedup rollout needs the env counter ({c}) aligned "
                f"to cam_every ({self.cam_every}); initialize the "
                f"TrainState via PPO.init() or step the env to a multiple "
                f"of cam_every first")

    @torch.no_grad()
    def rollout(self, ts: TrainState, seed: Optional[int] = None):
        """The plain rollout over the horizon (``seed`` is the fused
        trainers' kernel seed, unused here) -> (ts, Rollout, bootstrap
        value [N], per-term info means)."""
        cfg, H, dev = self.cfg, self.cfg.horizon, self.device
        n, ce, dedup = self.num_envs, self.cam_every, self.frame_dedup
        gen, rms = ts.generator, self._rms(ts)
        env_state, obs = ts.env_state, ts.obs
        ep_ret, ep_len = ts.ep_return, ts.ep_length
        last_ret, last_len = ts.last_ep_return, ts.last_ep_length
        last_suc = ts.last_ep_success
        last_env_suc = ts.last_ep_env_success
        store = lambda img: img.to(torch.bfloat16)

        feat = frames = images = frame_idx = None
        if dedup:
            self._check_phase(env_state)
            c0 = int(env_state.counter)
            feat = self._by_rank(
                lambda img: ts.model.encode_image(img, rms), obs["image"])
            frames = torch.empty((self.num_frames,) + obs["image"].shape,
                                 dtype=torch.bfloat16,
                                 device=dev)
            frames[0] = store(obs["image"])
            frame_idx = torch.tensor([(c0 + h) // ce - c0 // ce
                                      for h in range(H)], device=dev)
        elif self.obs_is_dict:
            images = torch.empty((H,) + obs["image"].shape,
                                 dtype=torch.bfloat16,
                                 device=dev)

        rec = {k: [] for k in ("obs", "prenorm", "actions", "neglogp",
                               "values", "mus", "sigmas", "rewards",
                               "dones", "timeouts")}
        info_sums: Dict[str, torch.Tensor] = {}
        for h in range(H):
            render, obs_pol = None, obs
            if dedup:
                render = h % ce == ce - 1
                obs_pol = {"observation": obs["observation"],
                           "features": feat}
            action, nlp, mu, sigma, value, prenorm = self._policy(
                ts, obs_pol, gen)
            env_state, out = self._step_env(
                env_state, torch.clamp(action, -1.0, 1.0), gen, render)

            # episode stats (reference a2c_base.py:680-695)
            d = out.reset
            ep_ret = ep_ret + out.reward
            ep_len = ep_len + 1.0
            last_ret = torch.where(d, ep_ret, last_ret)
            last_len = torch.where(d, ep_len, last_len)
            alive = 1.0 - d.to(ep_ret.dtype)
            ep_ret, ep_len = ep_ret * alive, ep_len * alive
            info = dict(out.info)
            success = info.pop("success", None)
            if last_suc is not None:
                if success is None:
                    raise ValueError(
                        f"{type(self.task).__name__} sets has_success but "
                        f"its step info has no 'success' entry")
                last_suc = torch.where(d, success.to(ep_ret.dtype), last_suc)
            env_success = info.pop("env_success", None)
            env_done = info.pop("env_done", None)
            if last_env_suc is not None:
                if env_success is None or env_done is None:
                    raise ValueError(
                        f"{type(self.task).__name__} sets has_env_success "
                        f"but its step info lacks 'env_success' / "
                        f"'env_done'")
                # on each whole-env reset: did any robot reach the goal
                last_env_suc = torch.where(
                    env_done, env_success.to(ep_ret.dtype), last_env_suc)
            for k, v in info.items():
                info_sums[k] = info_sums.get(k, 0.0) + torch.mean(
                    v.to(torch.float32))

            if self.obs_is_dict:
                rec["obs"].append(obs["observation"])
                if images is not None:
                    images[h] = store(obs["image"])
            else:
                rec["obs"].append(obs)
            for k, x in (("prenorm", prenorm), ("actions", action),
                         ("neglogp", nlp), ("values", value), ("mus", mu),
                         ("sigmas", sigma), ("rewards", out.reward),
                         ("dones", d), ("timeouts", out.timeout)):
                rec[k].append(x)
            obs = out.obs
            if dedup and render:
                # the just-rendered frame: features for the next block
                feat = self._by_rank(
                    lambda img: ts.model.encode_image(img, rms),
                    obs["image"])
                frames[(h + 1) // ce] = store(obs["image"])

        _, _, last_value = self._by_rank(lambda o: ts.model(o, rms), obs)
        traj = {k: torch.stack(v) for k, v in rec.items()}
        if self.obs_is_dict:
            traj["obs"] = {"observation": traj["obs"]}
            if images is not None:
                traj["obs"]["image"] = images
        traj = Rollout(**traj, frame_idx=frame_idx, frames=frames)
        ts = dataclasses.replace(
            ts, env_state=env_state, obs=obs, ep_return=ep_ret,
            ep_length=ep_len, last_ep_return=last_ret,
            last_ep_length=last_len, last_ep_success=last_suc,
            last_ep_env_success=last_env_suc)
        infos = {k: v / H for k, v in info_sums.items()}
        return ts, traj, last_value[:, 0], infos

    # ----------------------------------------------------------------- update

    def _loss_fn(self, model, obs_rms, value_rms, mb):
        """Total loss and the diagnostics of one minibatch (reference
        a2c_continuous.py:299-369)."""
        cfg = self.cfg
        obs = mb["obs"]
        feat_u = None
        if isinstance(obs, dict) and "pooled_unique" in obs:
            # a later mini-epoch of a frozen encoder: its head alone on
            # the head's input that the first kept (``update``)
            feat_u = model.encode_head(obs["pooled_unique"])
        elif isinstance(obs, dict) and "image_unique" in obs:
            # frame dedup: encode each unique frame once, gather per sample
            feat_u = model.encode_image(obs["image_unique"], obs_rms)
        if feat_u is not None:
            obs = {"observation": obs["observation"],
                   "features": feat_u[obs["feat_index"]]}
        mu, sigma, value = model(obs, obs_rms)
        value = value[..., 0]
        logstd = torch.log(sigma)
        nlp = ac.neglogp(mb["actions"], mu, sigma, logstd)

        ratio = torch.exp(mb["neglogp"] - nlp)
        surr1 = mb["adv"] * ratio
        lo, hi = 1.0 - cfg.e_clip, 1.0 + cfg.e_clip
        clamped = (losses.smooth_clamp(ratio, lo, hi) if cfg.use_smooth_clamp
                   else torch.clamp(ratio, lo, hi))
        surr2 = mb["adv"] * clamped
        a_loss = torch.maximum(-surr1, -surr2)

        if cfg.clip_value:
            v_clip = mb["values"] + torch.clamp(value - mb["values"],
                                                -cfg.e_clip, cfg.e_clip)
            c_loss = torch.maximum(torch.square(value - mb["returns"]),
                                   torch.square(v_clip - mb["returns"]))
        else:
            c_loss = torch.square(value - mb["returns"])

        b_loss = torch.sum(torch.square(torch.clamp_min(mu - 1.1, 0.0))
                           + torch.square(torch.clamp_max(mu + 1.1, 0.0)),
                           dim=-1)
        ent = ac.entropy(logstd)
        total = (torch.mean(a_loss)
                 + 0.5 * cfg.critic_coef * torch.mean(c_loss)
                 - cfg.entropy_coef * torch.mean(ent)
                 + cfg.bounds_loss_coef * torch.mean(b_loss))
        with torch.no_grad():
            aux = {"a_loss": torch.mean(a_loss), "c_loss": torch.mean(c_loss),
                   "b_loss": torch.mean(b_loss), "entropy": torch.mean(ent),
                   "kl": policy_kl(mb["mus"], mb["sigmas"], mu, sigma),
                   "clip_frac": torch.mean(
                       (torch.abs(ratio - 1.0) > cfg.e_clip).to(
                           torch.float32)),
                   "mu": mu.detach(), "sigma": sigma.detach()}
        return total, aux

    def _share(self, k: int, mb_size: int, rank: Optional[int] = None):
        """(start, length): the samples of minibatch k that rank ``rank``
        (this rank by default) takes in the update, an equal contiguous
        part of the minibatch (all of it on one rank)."""
        part = mb_size // self.shares
        rank = self.rank if rank is None else rank
        return k * mb_size + rank * part, part

    def _env_window(self, start: int, length: int):
        """(me, e0): the envs e0 .. e0 + me - 1 that the env-major span
        [start, start + length) touches; me = ceil(length / H) + 1,
        clamped to the env count (the reference leaves it unclamped in
        _mb_from_scan_layout, ppo.py:602)."""
        H, N = self.cfg.horizon, self.batch_envs
        me = min(-(-length // H) + 1, N)
        return me, min(start // H, N - me)

    def unique_window(self, frames: torch.Tensor, frame_idx: torch.Tensor,
                      k: int, mb_size: int, rank: Optional[int] = None):
        """Unique frames of a rank's share of minibatch k [F * me, ...]
        and each sample's index into them (``feat_index``)."""
        me, e0 = self._env_window(*self._share(k, mb_size, rank))
        win = frames[:, e0:e0 + me]
        img_u = win.reshape((frames.shape[0] * me,) + frames.shape[2:])
        return img_u, self.feat_index(frame_idx, k, mb_size, rank)

    def feat_index(self, frame_idx: torch.Tensor, k: int, mb_size: int,
                   rank: Optional[int] = None) -> torch.Tensor:
        """Each sample of a rank's share of minibatch k as an index into
        its window's unique frames: sample j = n * H + h reads frame
        frame_idx[h] of env n, at f * me + (n - e0)."""
        H = self.cfg.horizon
        start, length = self._share(k, mb_size, rank)
        me, e0 = self._env_window(start, length)
        j = start + torch.arange(length, device=frame_idx.device)
        return frame_idx[j % H] * me + (j // H - e0)

    def _mb_from_scan_layout(self, img: torch.Tensor, k: int, mb_size: int,
                             rank: Optional[int] = None):
        """Env-major share of minibatch k [length, ...] out of the
        rollout-layout images [H, N, ...] without transposing the whole
        buffer."""
        H = self.cfg.horizon
        start, length = self._share(k, mb_size, rank)
        me, e0 = self._env_window(start, length)
        win = img[:, e0:e0 + me].transpose(0, 1).reshape(
            (me * H,) + img.shape[2:])
        off = start - e0 * H
        return win[off:off + length]

    def _scheduled_lr(self, ts: TrainState) -> TrainState:
        """``ts`` with its epoch's lr under ``lr_schedule: linear``
        (kl-independent, so once per epoch equals the reference's
        per-minibatch application); other schedules keep ``ts.lr``."""
        cfg = self.cfg
        if cfg.lr_schedule != "linear":
            return ts
        lr, _ = schedulers.LinearScheduler(
            start_lr=cfg.learning_rate, min_lr=cfg.min_lr,
            max_steps=cfg.max_epochs).update(None, None, ts.epoch, ts.frame,
                                             None)
        return dataclasses.replace(ts, lr=torch.tensor(
            lr, dtype=torch.float32, device=self.device))

    def update(self, ts: TrainState, dataset: Dict[str, Any]):
        """mini_epochs x contiguous minibatches of autograd + Adam steps,
        the mu / sigma write-back the KL of later mini-epochs reads, the
        adaptive lr at each mini-epoch's end; metrics of the last
        mini-epoch.

        On several ranks every rank holds the whole batch (``train_epoch``
        gathers it) and takes its share of each minibatch (``_share``):
        its loss is the mean over its share over the rank count, so the
        gradients and the metrics summed over the ranks by one flat
        all-reduce per Adam step are the minibatch's; every rank then
        takes the same clip, Adam step and learning rate. The witness of
        an n-rank run (``shares``) computes the n shares in turn and sums
        them in rank order."""
        cfg = self.cfg
        nmb = self.num_minibatches
        mb_size = self.batch_size // nmb
        ts = self._scheduled_lr(ts)

        dataset = dict(dataset)
        frames = dataset.pop("frames", None)
        frame_idx = dataset.pop("frame_idx", None)
        obs = dataset.pop("obs")
        scan_img = None
        if isinstance(obs, dict):
            obs = dict(obs)
            scan_img = obs.pop("image", None)
        mus = dataset.pop("mus_init").clone()
        sigmas = dataset.pop("sigmas_init").clone()

        model, rms = ts.model, self._rms(ts)
        names, params = map(list, zip(*trainable(model).items()))
        m = [ts.adam["m"][k].clone() for k in names]
        v = [ts.adam["v"][k].clone() for k in names]
        count = ts.adam["count"].clone()
        lr = ts.lr.clone()
        # a frozen encoder's head input (``ActorCritic.frozen_head``) for
        # a window is the same in every mini-epoch: the frames, the image
        # stats and the frozen weights hold through the update. The first
        # keeps it by (minibatch, rank share), the later ones read it back
        keep = frames is not None and model.frozen_head() is not None
        memo: Dict[tuple, torch.Tensor] = {}
        for _ in range(cfg.mini_epochs):
            rows = []
            for k in range(nmb):
                # one Adam step: ``loss`` (the slices, the image window,
                # the loss), ``backward`` (the gradients, the zero fill,
                # the metrics row), ``adam`` (the all-reduce, the clip,
                # the step, the mu / sigma write-back)
                with profiling.span("minibatch"):
                    grads = row = None
                    written = []
                    for r in ([self.rank] if self.group is not None
                              else range(self.shares)):
                        with profiling.span("loss"):
                            start, length = self._share(k, mb_size, r)
                            sl = slice(start, start + length)
                            mb = {key: val[sl]
                                  for key, val in dataset.items()}
                            if isinstance(obs, dict):
                                mob = {key: val[sl]
                                       for key, val in obs.items()}
                                if (k, r) in memo:
                                    mob["pooled_unique"] = memo[(k, r)]
                                    mob["feat_index"] = self.feat_index(
                                        frame_idx, k, mb_size, r)
                                elif frames is not None:
                                    mob["image_unique"], mob["feat_index"] \
                                        = self.unique_window(
                                            frames, frame_idx, k, mb_size, r)
                                elif scan_img is not None:
                                    mob["image"] = self._mb_from_scan_layout(
                                        scan_img, k, mb_size, r)
                            else:
                                mob = obs[sl]
                            mb["obs"], mb["mus"], mb["sigmas"] = \
                                mob, mus[sl], sigmas[sl]
                            with (model.keep_head_input(memo, (k, r))
                                  if keep and (k, r) not in memo
                                  else contextlib.nullcontext()):
                                loss, aux = self._loss_fn(model, rms,
                                                          ts.value_rms, mb)
                            if self.shares > 1:
                                loss = loss / self.shares
                        with profiling.span("backward"):
                            g = torch.autograd.grad(loss, params,
                                                    allow_unused=True)
                            g = [torch.zeros_like(p) if gi is None else gi
                                 for p, gi in zip(params, g)]
                            rw = torch.stack([loss.detach()] + [
                                aux[key] / self.shares
                                for key in METRICS[1:]])
                            if grads is None:
                                grads, row = g, rw
                            else:
                                grads = [a + b for a, b in zip(grads, g)]
                                row = row + rw
                            written.append((sl, aux.pop("mu"),
                                            aux.pop("sigma")))
                    with profiling.span("adam"):
                        if self.group is not None:
                            grads, row = self._all_reduce(grads, row)
                        with torch.no_grad():
                            if cfg.truncate_grads:
                                gnorm = torch.linalg.vector_norm(
                                    torch.stack(torch._foreach_norm(grads)))
                                scale = torch.clamp_max(
                                    cfg.grad_norm
                                    / torch.clamp_min(gnorm, 1e-6), 1.0)
                                torch._foreach_mul_(grads, scale)
                            adam_step(params, grads, m, v, count, lr)
                            for sl, mu, sigma in written:
                                mus[sl], sigmas[sl] = mu, sigma
                rows.append(row)
            means = torch.stack(rows).mean(0)
            if cfg.lr_schedule == "adaptive":
                av_kl, thr = means[1], cfg.kl_threshold
                lr = torch.where(av_kl > 2.0 * thr,
                                 torch.clamp_min(lr / 1.5, cfg.min_lr), lr)
                lr = torch.where(av_kl < 0.5 * thr,
                                 torch.clamp_max(lr * 1.5, cfg.max_lr), lr)
        metrics = {key: means[i] for i, key in enumerate(METRICS)}
        adam = {"m": dict(zip(names, m)), "v": dict(zip(names, v)),
                "count": count}
        return dataclasses.replace(ts, adam=adam, lr=lr), metrics

    def _all_reduce(self, grads, row):
        """Sum the gradients and the metrics row over the ranks in one flat
        all-reduce. The gradients come back as tensors of their own, as
        autograd gives them: the clip's torch._foreach_norm adds in
        another order over views at unaligned offsets of one buffer (on an
        H100)."""
        sizes = [g.numel() for g in grads]
        flat = torch.cat([g.reshape(-1) for g in grads] + [row])
        flat = pdist.all_reduce(flat)
        parts = torch.split(flat, sizes + [row.numel()])
        return ([p.reshape(g.shape).clone() for p, g in zip(parts, grads)],
                parts[-1])

    def _gather(self, traj: Rollout, last_value, infos, episodes):
        """The rollouts of all ranks as one batch along the env axis (the
        frame indices are the same on every rank), the per-term info
        means averaged over the ranks."""
        cat = lambda x, dim: (None if x is None
                              else pdist.all_gather_cat(x, dim))
        fields = {}
        for k, v in traj._asdict().items():
            if k == "frame_idx":
                fields[k] = v
            elif isinstance(v, dict):
                fields[k] = {kk: cat(vv, 1) for kk, vv in v.items()}
            else:
                fields[k] = cat(v, 1)
        if infos:
            sums = pdist.all_reduce(torch.stack(
                [v.to(torch.float32) for v in infos.values()]))
            infos = {k: s / self.world for k, s in zip(infos, sums)}
        return (Rollout(**fields), cat(last_value, 0), infos,
                tuple(cat(e, 0) for e in episodes))

    # -------------------------------------------------------------- epoch

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

    def _prepare(self, ts: TrainState, traj: Rollout, last_value):
        """GAE, the running stats and the dataset (spans ``gae``,
        ``stats``, ``dataset``) -> (ts with the new stats, values and
        returns [H, N], the dataset ``update`` takes)."""
        cfg = self.cfg
        with profiling.span("gae"):
            values, adv, returns = self.compute_gae(ts, traj, last_value)

        with profiling.span("stats"):
            if cfg.normalize_input:
                if isinstance(ts.obs_rms, dict):
                    # the per-pixel stats run over the unique frames with
                    # frame dedup (each seen cam_every steps)
                    imgs = (traj.frames if traj.frames is not None
                            else traj.obs["image"])
                    obs_rms = {
                        "image": ts.obs_rms["image"].update(imgs),
                        "observation": ts.obs_rms["observation"].update(
                            traj.prenorm)}
                else:
                    obs_rms = ts.obs_rms.update(traj.prenorm)
                ts = dataclasses.replace(ts, obs_rms=obs_rms)
            if cfg.normalize_value:
                vr = ts.value_rms.update(values).update(returns)
                ts = dataclasses.replace(ts, value_rms=vr)
                values_m = vr.normalize(values)
                returns_m = vr.normalize(returns)
            else:
                values_m, returns_m = values, returns
            if cfg.normalize_rms_advantage:
                adv_ms = mstats.update_mean_std(ts.adv_ms, adv,
                                                decay=RMS_ADVANTAGE_DECAY)
                ts = dataclasses.replace(ts, adv_ms=adv_ms)
                adv = mstats.normalize(adv_ms, adv)
            elif cfg.normalize_advantage:
                adv = (adv - torch.mean(adv)) / (
                    torch.std(adv, unbiased=False) + 1e-8)

        with profiling.span("dataset"):
            dataset = self._dataset(ts, traj, values_m, returns_m, adv)
        return ts, values, returns, dataset

    def _dataset(self, ts: TrainState, traj: Rollout, values_m, returns_m,
                 adv) -> Dict[str, Any]:
        """[H, N, ...] -> env-major [N*H, ...]: contiguous minibatches
        group whole trajectories like the reference's PPODataset; the
        images stay in rollout layout (see update)."""
        def flat(x):
            x = torch.transpose(x, 0, 1)
            return x.reshape((self.batch_size,) + x.shape[2:]).contiguous()

        obs = traj.obs
        obs = ({k: (v if k == "image" else flat(v)) for k, v in obs.items()}
               if isinstance(obs, dict) else flat(obs))
        dataset = {
            "obs": obs, "actions": flat(traj.actions),
            "neglogp": flat(traj.neglogp), "values": flat(values_m),
            "returns": flat(returns_m), "adv": flat(adv),
            "mus_init": flat(traj.mus), "sigmas_init": flat(traj.sigmas),
        }
        if traj.frames is not None:
            dataset["frames"] = traj.frames
            dataset["frame_idx"] = traj.frame_idx
        return dataset

    def train_epoch(self, ts: TrainState, seed: Optional[int] = None):
        """Rollout + GAE + dataset + update. ``seed`` fixes the fused
        rollout kernel's int32 seed (tests use it to replay the JAX
        side's). Spans (rl/profiling.py): ``epoch`` (id ``ts.epoch``)
        over ``rollout``, ``gae``, ``stats``, ``dataset``, ``update``."""
        if self._minibatch_error:
            raise ValueError(self._minibatch_error)
        with profiling.span("epoch", ts.epoch):
            return self._train_epoch(ts, seed)

    def _train_epoch(self, ts: TrainState, seed: Optional[int]):
        with profiling.span("rollout"):
            ts, traj, last_value, infos = self.rollout(ts, seed=seed)
        episodes = (ts.last_ep_return, ts.last_ep_length, ts.last_ep_success,
                    ts.last_ep_env_success)
        if self.group is not None:
            traj, last_value, infos, episodes = self._gather(
                traj, last_value, infos, episodes)
        elif self.witness:
            # the ranks' gathered batch is contiguous, and a reduction's
            # order may follow the layout
            dense = lambda v: (None if v is None else
                               {k: dense(x) for k, x in v.items()}
                               if isinstance(v, dict) else v.contiguous())
            traj = Rollout(**{k: dense(v) for k, v in traj._asdict().items()})
            last_value = last_value.contiguous()
        ep_return, ep_length, ep_success, ep_env_success = episodes
        ts, values, returns, dataset = self._prepare(ts, traj, last_value)
        with profiling.span("update"):
            ts, metrics = self.update(ts, dataset)
        ts = dataclasses.replace(ts, epoch=ts.epoch + 1,
                                 frame=ts.frame + self.batch_size)
        metrics = dict(metrics)
        metrics["lr"] = ts.lr
        metrics["mean_reward"] = torch.mean(ep_return)
        metrics["mean_ep_length"] = torch.mean(ep_length)
        metrics["reward_raw_per_step"] = torch.mean(traj.rewards)
        if ep_success is not None:
            # share of the last finished episodes that ended in success
            metrics["success_rate"] = torch.mean(ep_success)
        if ep_env_success is not None:
            # the env-level rate: per-robot success is capped near 1 / R
            metrics["env_success_rate"] = torch.mean(ep_env_success)
        var_ret = torch.var(returns, unbiased=False)
        metrics["explained_variance"] = 1.0 - torch.var(
            returns - values, unbiased=False) / (var_ret + 1e-8)
        for k, v in infos.items():
            metrics[f"Episode/{k}"] = torch.mean(v)
        return ts, metrics
