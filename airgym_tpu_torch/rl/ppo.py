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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch

from airgym_tpu_torch.models import actor_critic as ac
from airgym_tpu_torch.rl import losses
from airgym_tpu_torch.rl import moving_stats as mstats
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
                 network_kw: Optional[dict] = None):
        self.task = task
        self.cfg = cfg
        self.device = task.device
        # actors: the envs, or envs x robots for a task that flattens its
        # robot axis (MAPlanning's flat_n)
        self.num_envs = getattr(task, "flat_n", task.cfg.num_envs)
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

    def _policy(self, ts: TrainState, obs, generator):
        mu, sigma, value, prenorm = ts.model(obs, self._rms(ts),
                                             return_prenorm=True)
        action = mu + sigma * torch.randn(mu.shape, generator=generator,
                                          dtype=mu.dtype, device=mu.device)
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
            feat = ts.model.encode_image(obs["image"], rms)
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
                feat = ts.model.encode_image(obs["image"], rms)
                frames[(h + 1) // ce] = store(obs["image"])

        _, _, last_value = ts.model(obs, rms)
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
        if isinstance(obs, dict) and "image_unique" in obs:
            # frame dedup: encode each unique frame once, gather per sample
            feat_u = model.encode_image(obs["image_unique"], obs_rms)
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

    def _env_window(self, k: int, mb_size: int):
        """(me, e0): the envs e0 .. e0 + me - 1 that the env-major span
        [k*mb, (k+1)*mb) touches; me = ceil(mb / H) + 1, clamped to the
        env count (the reference leaves it unclamped in
        _mb_from_scan_layout, ppo.py:602)."""
        H, N = self.cfg.horizon, self.num_envs
        me = min(-(-mb_size // H) + 1, N)
        return me, min(k * mb_size // H, N - me)

    def unique_window(self, frames: torch.Tensor, frame_idx: torch.Tensor,
                      k: int, mb_size: int):
        """Unique frames of minibatch k [F * me, ...] and each sample's
        index into them: sample j = n * H + h reads frame frame_idx[h] of
        env n, at f * me + (n - e0)."""
        H = self.cfg.horizon
        me, e0 = self._env_window(k, mb_size)
        win = frames[:, e0:e0 + me]
        img_u = win.reshape((frames.shape[0] * me,) + frames.shape[2:])
        j = k * mb_size + torch.arange(mb_size, device=frames.device)
        return img_u, frame_idx[j % H] * me + (j // H - e0)

    def _mb_from_scan_layout(self, img: torch.Tensor, k: int, mb_size: int):
        """Env-major minibatch [mb, ...] out of the rollout-layout images
        [H, N, ...] without transposing the whole buffer."""
        H = self.cfg.horizon
        me, e0 = self._env_window(k, mb_size)
        win = img[:, e0:e0 + me].transpose(0, 1).reshape(
            (me * H,) + img.shape[2:])
        off = k * mb_size - e0 * H
        return win[off:off + mb_size]

    def update(self, ts: TrainState, dataset: Dict[str, Any]):
        """mini_epochs x contiguous minibatches of autograd + Adam steps,
        the mu / sigma write-back the KL of later mini-epochs reads, the
        adaptive lr at each mini-epoch's end; metrics of the last
        mini-epoch."""
        cfg = self.cfg
        nmb = self.num_minibatches
        mb_size = self.batch_size // nmb
        if cfg.lr_schedule == "linear":
            # kl-independent, so once per epoch equals the reference's
            # per-minibatch application
            mul = max(0.0, 1.0 - ts.epoch / cfg.max_epochs)
            ts = dataclasses.replace(ts, lr=torch.tensor(
                max(cfg.min_lr, cfg.learning_rate * mul), dtype=torch.float32,
                device=self.device))

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
        for _ in range(cfg.mini_epochs):
            rows = []
            for k in range(nmb):
                sl = slice(k * mb_size, (k + 1) * mb_size)
                mb = {key: val[sl] for key, val in dataset.items()}
                if isinstance(obs, dict):
                    mob = {key: val[sl] for key, val in obs.items()}
                    if frames is not None:
                        mob["image_unique"], mob["feat_index"] = \
                            self.unique_window(frames, frame_idx, k, mb_size)
                    elif scan_img is not None:
                        mob["image"] = self._mb_from_scan_layout(
                            scan_img, k, mb_size)
                else:
                    mob = obs[sl]
                mb["obs"], mb["mus"], mb["sigmas"] = mob, mus[sl], sigmas[sl]
                loss, aux = self._loss_fn(model, rms, ts.value_rms, mb)
                grads = torch.autograd.grad(loss, params, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(params, grads)]
                with torch.no_grad():
                    if cfg.truncate_grads:
                        gnorm = torch.linalg.vector_norm(
                            torch.stack(torch._foreach_norm(grads)))
                        scale = torch.clamp_max(
                            cfg.grad_norm / torch.clamp_min(gnorm, 1e-6), 1.0)
                        torch._foreach_mul_(grads, scale)
                    adam_step(params, grads, m, v, count, lr)
                    mus[sl] = aux.pop("mu")
                    sigmas[sl] = aux.pop("sigma")
                rows.append(torch.stack([loss.detach()] + [
                    aux[key] for key in METRICS[1:]]))
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

    def train_epoch(self, ts: TrainState, seed: Optional[int] = None):
        """Rollout + GAE + dataset + update. ``seed`` fixes the fused
        rollout kernel's int32 seed (tests use it to replay the JAX
        side's)."""
        if self._minibatch_error:
            raise ValueError(self._minibatch_error)
        cfg = self.cfg
        ts, traj, last_value, infos = self.rollout(ts, seed=seed)
        values, adv, returns = self.compute_gae(ts, traj, last_value)

        if cfg.normalize_input:
            if isinstance(ts.obs_rms, dict):
                # the per-pixel stats run over the unique frames with
                # frame dedup (each seen cam_every steps)
                imgs = (traj.frames if traj.frames is not None
                        else traj.obs["image"])
                obs_rms = {"image": ts.obs_rms["image"].update(imgs),
                           "observation": ts.obs_rms["observation"].update(
                               traj.prenorm)}
            else:
                obs_rms = ts.obs_rms.update(traj.prenorm)
            ts = dataclasses.replace(ts, obs_rms=obs_rms)
        if cfg.normalize_value:
            vr = ts.value_rms.update(values).update(returns)
            ts = dataclasses.replace(ts, value_rms=vr)
            values_m, returns_m = vr.normalize(values), vr.normalize(returns)
        else:
            values_m, returns_m = values, returns
        if cfg.normalize_rms_advantage:
            adv_ms = mstats.update_mean_std(ts.adv_ms, adv,
                                            decay=RMS_ADVANTAGE_DECAY)
            ts = dataclasses.replace(ts, adv_ms=adv_ms)
            adv = mstats.normalize(adv_ms, adv)
        elif cfg.normalize_advantage:
            adv = (adv - torch.mean(adv)) / (torch.std(adv, unbiased=False)
                                             + 1e-8)

        # [H, N, ...] -> env-major [N*H, ...]: contiguous minibatches group
        # whole trajectories like the reference's PPODataset; the images
        # stay in rollout layout (see update)
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
        if ts.last_ep_env_success is not None:
            # the env-level rate: per-robot success is capped near 1 / R
            metrics["env_success_rate"] = torch.mean(ts.last_ep_env_success)
        var_ret = torch.var(returns, unbiased=False)
        metrics["explained_variance"] = 1.0 - torch.var(
            returns - values, unbiased=False) / (var_ret + 1e-8)
        for k, v in infos.items():
            metrics[f"Episode/{k}"] = torch.mean(v)
        return ts, metrics
