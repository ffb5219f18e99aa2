"""PPO trainer, as the two configurations run it.

One ``train_epoch`` = the rollout, GAE with the reference's discount,
reward shaping and value bootstrap on time-outs, the running-stat
updates, advantage normalization, the env-major flattening into
contiguous minibatches (no shuffle, as the reference's PPODataset), and
the update phase.

``PPO`` is the plain trainer: a Python loop over the horizon (policy
forward, Gaussian sample, env step) and an autograd minibatch update with
the reference's global-norm scale ``min(1, g / max(|grads|, 1e-6))`` (not
``clip_grad_norm_``), optax's Adam (eps outside the square root, lr folded
in after the bias-corrected step, one shared step count) and the adaptive
learning rate. ``rl/fused_ppo.py`` replaces the rollout and the update of
Hovering with the fused kernels' plain versions.

Camera tasks (dict obs) use frame dedup: the camera renders every
``cam_every`` steps, ``init`` phase-aligns the render cadence to the
rollout's blocks, the rollout renders on the last step of each block (a
static ``render`` flag), encodes each new frame once and stores only the
unique frames, in bfloat16. Minibatches gather their (frame, env) pairs
from a window of envs (``unique_window``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch

from portbench.reference.plain.models import actor_critic as ac
from portbench.reference.plain.rl.running_stats import RunningMeanStd

B1, B2, EPS = 0.9, 0.999, 1e-8
METRICS = ("loss", "kl", "a_loss", "c_loss", "b_loss", "entropy",
           "clip_frac")


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """The YAML's numbers the trainer reads; the switches both
    configurations set (adaptive lr, input / value / advantage
    normalization, value bootstrap, gradient truncation, no value clip) are
    the only behaviour built in (``reference/train.build`` checks them)."""
    horizon: int
    minibatch_size: int
    mini_epochs: int
    gamma: float
    tau: float
    learning_rate: float
    kl_threshold: float
    e_clip: float
    critic_coef: float
    entropy_coef: float
    bounds_loss_coef: float
    grad_norm: float
    reward_shaper_scale: float
    max_epochs: int
    min_lr: float = 1e-6
    max_lr: float = 1e-2


@dataclasses.dataclass
class TrainState:
    """Everything a train epoch reads and writes. ``model`` holds the
    parameters (updated in place); ``adam`` holds the moments under the
    parameter names and the shared step count; ``generator`` draws the
    env's noise, resets and the policy's samples on its device,
    ``seed_generator`` (CPU) draws the rollout kernel's int32 seeds.
    ``obs_rms`` is a dict {'image', 'observation'} for camera tasks."""
    model: ac.ActorCritic
    adam: Dict[str, Any]
    obs_rms: Any
    value_rms: RunningMeanStd
    env_state: Any
    obs: Any                        # last raw obs [N, obs] or dict
    lr: torch.Tensor                # 0-d float32, adapted by KL
    epoch: int
    generator: torch.Generator
    seed_generator: torch.Generator


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
    """The parameters Adam steps: all but a frozen encoder's, which have
    ``requires_grad`` off."""
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

    def __init__(self, task, cfg: PPOConfig, network: dict):
        self.task = task
        self.cfg = cfg
        self.device = task.device
        self.num_envs = task.cfg.num_envs
        self.num_actions = task.cfg.num_actions
        self.network = network
        self.batch_size = self.num_envs * cfg.horizon
        self.num_minibatches = max(1, self.batch_size // cfg.minibatch_size)
        if self.batch_size % self.num_minibatches:
            raise ValueError(
                f"minibatch_size ({cfg.minibatch_size}) must divide the "
                f"rollout batch ({self.batch_size}) into equal minibatches")
        self.obs_is_dict = bool(getattr(task, "obs_is_dict", False))
        self.cam_every = task.cfg.cam_every
        if self.obs_is_dict and (self.cam_every < 2
                                 or cfg.horizon % self.cam_every):
            raise ValueError(f"camera tasks run with frame dedup: cam_every "
                             f"({self.cam_every}) has to divide the horizon "
                             f"({cfg.horizon})")
        self.num_frames = cfg.horizon // self.cam_every + 1
        # a run over ``ranks`` processes, done in one: the policy runs on
        # each rank's block of envs, and each minibatch is taken in the
        # ranks' equal shares whose gradients add in rank order, or in
        # ``sum_order`` (a permutation of the ranks)
        self.ranks = 1
        self.sum_order = None

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
        if self.obs_is_dict:
            # phase-align the render cadence to the rollout blocks: with
            # counter % cam_every == 0 at a rollout's start, each render
            # lands on the last step of a cam_every block
            for _ in range(self.cam_every - 1):
                env_state, out0 = self.task.step(env_state, zero, gen)
        model = ac.build(self.network, self.task.num_obs, self.num_actions,
                         self.obs_is_dict, seed_gen).to(dev)
        if self.obs_is_dict:
            obs_rms = {
                "image": RunningMeanStd.create(out0.obs["image"].shape[1:],
                                               dev),
                "observation": RunningMeanStd.create(
                    (self.task.num_obs + model.image_features,), dev)}
        else:
            obs_rms = RunningMeanStd.create((self.task.num_obs,), dev)
        return TrainState(
            model=model, adam=adam_init(model), obs_rms=obs_rms,
            value_rms=RunningMeanStd.create((), dev),
            env_state=env_state, obs=out0.obs,
            lr=torch.tensor(self.cfg.learning_rate, dtype=torch.float32,
                            device=dev),
            epoch=0, generator=gen, seed_generator=seed_gen)

    # ---------------------------------------------------------------- rollout

    def _by_rank(self, fn, obs):
        """``fn(obs)``, or over each rank's block of envs, concatenated."""
        if self.ranks == 1:
            return fn(obs)
        n = self.num_envs // self.ranks
        rows = lambda x, r: ({k: v[r * n:(r + 1) * n] for k, v in x.items()}
                             if isinstance(x, dict) else x[r * n:(r + 1) * n])
        outs = [fn(rows(obs, r)) for r in range(self.ranks)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(o) for o in zip(*outs))
        return torch.cat(outs)

    def _policy(self, ts: TrainState, obs, generator):
        mu, sigma, value, prenorm = self._by_rank(
            lambda o: ts.model(o, ts.obs_rms, return_prenorm=True), obs)
        action = mu + sigma * torch.randn(mu.shape, generator=generator,
                                          dtype=mu.dtype, device=mu.device)
        nlp = ac.neglogp(action, mu, sigma, torch.log(sigma))
        return action, nlp, mu, sigma, value[..., 0], prenorm

    @torch.no_grad()
    def rollout(self, ts: TrainState):
        """The plain rollout over the horizon -> (ts, Rollout, bootstrap
        value [N])."""
        H, dev = self.cfg.horizon, self.device
        ce, dedup = self.cam_every, self.obs_is_dict
        gen, rms = ts.generator, ts.obs_rms
        env_state, obs = ts.env_state, ts.obs

        feat = frames = frame_idx = None
        if dedup:
            c0 = int(env_state.counter)
            feat = self._by_rank(lambda img: ts.model.encode_image(img, rms),
                                 obs["image"])
            frames = torch.empty((self.num_frames,) + obs["image"].shape,
                                 dtype=torch.bfloat16, device=dev)
            frames[0] = obs["image"].to(torch.bfloat16)
            frame_idx = torch.tensor([(c0 + h) // ce - c0 // ce
                                      for h in range(H)], device=dev)

        rec = {k: [] for k in ("obs", "prenorm", "actions", "neglogp",
                               "values", "mus", "sigmas", "rewards",
                               "dones", "timeouts")}
        for h in range(H):
            render, obs_pol = None, obs
            if dedup:
                render = h % ce == ce - 1
                obs_pol = {"observation": obs["observation"],
                           "features": feat}
            action, nlp, mu, sigma, value, prenorm = self._policy(
                ts, obs_pol, gen)
            env_state, out = self.task.step(
                env_state, torch.clamp(action, -1.0, 1.0), gen,
                **({"render": render} if dedup else {}))
            rec["obs"].append(obs["observation"] if dedup else obs)
            for k, x in (("prenorm", prenorm), ("actions", action),
                         ("neglogp", nlp), ("values", value), ("mus", mu),
                         ("sigmas", sigma), ("rewards", out.reward),
                         ("dones", out.reset), ("timeouts", out.timeout)):
                rec[k].append(x)
            obs = out.obs
            if dedup and render:
                # the just-rendered frame: features for the next block
                feat = self._by_rank(
                    lambda img: ts.model.encode_image(img, rms),
                    obs["image"])
                frames[(h + 1) // ce] = obs["image"].to(torch.bfloat16)

        _, _, last_value = self._by_rank(lambda o: ts.model(o, rms), obs)
        traj = {k: torch.stack(v) for k, v in rec.items()}
        if dedup:
            traj["obs"] = {"observation": traj["obs"]}
        traj = Rollout(**traj, frame_idx=frame_idx, frames=frames)
        ts = dataclasses.replace(ts, env_state=env_state, obs=obs)
        return ts, traj, last_value[:, 0]

    # ----------------------------------------------------------------- update

    def _loss_fn(self, model, obs_rms, value_rms, mb):
        """Total loss and the diagnostics of one minibatch (reference
        a2c_continuous.py:299-369)."""
        cfg = self.cfg
        obs = mb["obs"]
        if isinstance(obs, dict):
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
        surr2 = mb["adv"] * torch.clamp(ratio, 1.0 - cfg.e_clip,
                                        1.0 + cfg.e_clip)
        a_loss = torch.maximum(-surr1, -surr2)
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

    def unique_window(self, frames: torch.Tensor, frame_idx: torch.Tensor,
                      start: int, length: int):
        """Unique frames of the minibatch [start, start + length) [F * me,
        ...] and each sample's index into them: sample j = n * H + h reads
        frame frame_idx[h] of env n, at f * me + (n - e0), over the envs
        e0 .. e0 + me - 1 that the env-major span touches (me = ceil(length
        / H) + 1, clamped to the env count)."""
        H, N = self.cfg.horizon, self.num_envs
        me = min(-(-length // H) + 1, N)
        e0 = min(start // H, N - me)
        win = frames[:, e0:e0 + me]
        img_u = win.reshape((frames.shape[0] * me,) + frames.shape[2:])
        j = start + torch.arange(length, device=frames.device)
        return img_u, frame_idx[j % H] * me + (j // H - e0)

    def update(self, ts: TrainState, dataset: Dict[str, Any]):
        """mini_epochs x contiguous minibatches of autograd + Adam steps,
        the mu / sigma write-back the KL of later mini-epochs reads, the
        adaptive lr at each mini-epoch's end; metrics of the last
        mini-epoch."""
        cfg = self.cfg
        nmb = self.num_minibatches
        mb_size = self.batch_size // nmb
        part = mb_size // self.ranks
        dataset = dict(dataset)
        frames = dataset.pop("frames", None)
        frame_idx = dataset.pop("frame_idx", None)
        obs = dataset.pop("obs")
        mus = dataset.pop("mus_init").clone()
        sigmas = dataset.pop("sigmas_init").clone()

        model, rms = ts.model, ts.obs_rms
        names, params = map(list, zip(*trainable(model).items()))
        m = [ts.adam["m"][k].clone() for k in names]
        v = [ts.adam["v"][k].clone() for k in names]
        count = ts.adam["count"].clone()
        lr = ts.lr.clone()
        for _ in range(cfg.mini_epochs):
            rows = []
            for k in range(nmb):
                shares, written = [], []
                for r in range(self.ranks):
                    start = k * mb_size + r * part
                    sl = slice(start, start + part)
                    mb = {key: val[sl] for key, val in dataset.items()}
                    if isinstance(obs, dict):
                        mob = {key: val[sl] for key, val in obs.items()}
                        mob["image_unique"], mob["feat_index"] = \
                            self.unique_window(frames, frame_idx, start, part)
                    else:
                        mob = obs[sl]
                    mb["obs"], mb["mus"], mb["sigmas"] = \
                        mob, mus[sl], sigmas[sl]
                    loss, aux = self._loss_fn(model, rms, ts.value_rms, mb)
                    if self.ranks > 1:
                        loss = loss / self.ranks
                    g = list(torch.autograd.grad(loss, params))
                    rw = torch.stack([loss.detach()] + [
                        aux[key] / self.ranks for key in METRICS[1:]])
                    shares.append((g, rw))
                    written.append((sl, aux["mu"], aux["sigma"]))
                order = self.sum_order or range(self.ranks)
                grads, row = shares[order[0]]
                for r in order[1:]:
                    grads = [a + b for a, b in zip(grads, shares[r][0])]
                    row = row + shares[r][1]
                rows.append(row)
                with torch.no_grad():
                    gnorm = torch.linalg.vector_norm(
                        torch.stack(torch._foreach_norm(grads)))
                    scale = torch.clamp_max(
                        cfg.grad_norm / torch.clamp_min(gnorm, 1e-6), 1.0)
                    torch._foreach_mul_(grads, scale)
                    adam_step(params, grads, m, v, count, lr)
                    for sl, mu, sigma in written:
                        mus[sl], sigmas[sl] = mu, sigma
            means = torch.stack(rows).mean(0)
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
        values = ts.value_rms.denormalize(traj.values)      # [H, N]
        last_v = ts.value_rms.denormalize(last_value)       # [N]
        rew = traj.rewards * cfg.reward_shaper_scale
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

    def train_epoch(self, ts: TrainState):
        """Rollout + GAE + dataset + update -> (ts, metrics)."""
        ts, traj, last_value = self.rollout(ts)[:3]
        values, adv, returns = self.compute_gae(ts, traj, last_value)

        if isinstance(ts.obs_rms, dict):
            # the per-pixel stats run over the unique frames
            obs_rms = {"image": ts.obs_rms["image"].update(traj.frames),
                       "observation": ts.obs_rms["observation"].update(
                           traj.prenorm)}
        else:
            obs_rms = ts.obs_rms.update(traj.prenorm)
        vr = ts.value_rms.update(values).update(returns)
        ts = dataclasses.replace(ts, obs_rms=obs_rms, value_rms=vr)
        adv = (adv - torch.mean(adv)) / (torch.std(adv, unbiased=False)
                                         + 1e-8)

        # [H, N, ...] -> env-major [N*H, ...]: contiguous minibatches group
        # whole trajectories like the reference's PPODataset
        def flat(x):
            x = torch.transpose(x, 0, 1)
            return x.reshape((self.batch_size,) + x.shape[2:]).contiguous()

        obs = traj.obs
        obs = ({k: flat(v) for k, v in obs.items()} if isinstance(obs, dict)
               else flat(obs))
        dataset = {
            "obs": obs, "actions": flat(traj.actions),
            "neglogp": flat(traj.neglogp),
            "values": flat(vr.normalize(values)),
            "returns": flat(vr.normalize(returns)), "adv": flat(adv),
            "mus_init": flat(traj.mus), "sigmas_init": flat(traj.sigmas),
        }
        if traj.frames is not None:
            dataset["frames"] = traj.frames
            dataset["frame_idx"] = traj.frame_idx
        ts, metrics = self.update(ts, dataset)
        ts = dataclasses.replace(ts, epoch=ts.epoch + 1)
        return ts, dict(metrics, lr=ts.lr)
