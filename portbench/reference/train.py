"""The plain reference of a training cell: the trainer the runner would
build from the frozen YAML params, in the frozen plain copy
(``reference/plain``), driven from the seed through its first epochs.

It works out again everything the program derives from the seed: the
env batch, the weights, the rollouts' draws, GAE, the running stats and
every Adam step. Float32 with TF32 off, as the configuration states; the
CNN's convolutions in bf16, as the configuration states; ``tf32=True``
is the control, one precision below.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from portbench.reference.plain import envs
from portbench.reference.plain.rl import fused_ppo
from portbench.reference.plain.rl import ppo as ppo_mod

TILE = 1024


class Snapshot(NamedTuple):
    """What a training run is judged by: each epoch's loss, Adam's first
    moment per leaf after the first epoch, the parameters before the
    first epoch, after it and after the last, and the first epoch's
    rollout (its ``Rollout`` fields and bootstrap values, copied)."""
    losses: list
    m1: Dict[str, torch.Tensor]
    p0: Dict[str, torch.Tensor]
    p1: Dict[str, torch.Tensor]
    p_end: Dict[str, torch.Tensor]
    rollout: Dict[str, Any]
    last_value: torch.Tensor
    lr1: float
    metrics1: Dict[str, float]


# the switches the reference's trainers build in (rl/ppo.PPOConfig)
BUILT_IN = {"lr_schedule": "adaptive", "clip_value": False,
            "normalize_input": True, "normalize_value": True,
            "normalize_advantage": True, "value_bootstrap": True,
            "truncate_grads": True}


def ppo_config(params: Dict[str, Any]) -> ppo_mod.PPOConfig:
    c = params["config"]
    off = {k: c.get(k) for k, v in BUILT_IN.items() if c.get(k) != v}
    if off:
        raise ValueError(f"the reference trains with {BUILT_IN}, got {off}")
    return ppo_mod.PPOConfig(
        horizon=int(c["horizon_length"]),
        minibatch_size=int(c["minibatch_size"]),
        mini_epochs=int(c["mini_epochs"]),
        gamma=float(c["gamma"]), tau=float(c["tau"]),
        learning_rate=float(c["learning_rate"]),
        kl_threshold=float(c["kl_threshold"]),
        e_clip=float(c["e_clip"]),
        critic_coef=float(c["critic_coef"]),
        entropy_coef=float(c["entropy_coef"]),
        bounds_loss_coef=float(c["bounds_loss_coef"]),
        grad_norm=float(c["grad_norm"]),
        reward_shaper_scale=float(c["reward_shaper"]["scale_value"]),
        max_epochs=int(c["max_epochs"]))


def build(params: Dict[str, Any], device, ranks: int = 1):
    """The trainer for ``params`` on ``device``: the fused Hovering trainer
    where the YAML asks for it (the runner's rule: Hovering, rate mode,
    envs in whole tiles of 1024), else the plain PPO; ``ranks`` > 1 (plain
    PPO) does a run over that many ranks in one process (``PPO.ranks``)."""
    c = params["config"]
    env_kw = dict(c.get("env_config") or {})
    env_kw.pop("use_image", None)
    task = envs.make_task(c["env_name"], int(c["num_actors"]), device,
                          **env_kw)
    fused = (c.get("use_fused_rollout") and c["env_name"] == "hovering"
             and int(c["num_actors"]) % TILE == 0)
    cls = fused_ppo.FusedHoveringPPO if fused else ppo_mod.PPO
    trainer = cls(task, ppo_config(params), params["network"])
    if ranks > 1:
        if fused:
            raise ValueError("the fused reference runs in one rank")
        trainer.ranks = ranks
    return trainer


class FirstSteps:
    """The first Adam steps of a trainer's update as ``adam_step`` gets
    them, to the last of ``marks`` (step counts, ascending): the loss of
    each minibatch or share (``_loss_fn``, in call order), the first
    step's gradient norms by leaf, and the norms of the parameters'
    change over the steps to each mark. ``module`` is the one whose
    ``adam_step`` the trainer's update calls (this reference's
    ``plain/rl/ppo``, or the program's); ``watch`` from ``init`` on,
    ``close`` after the first update. With ``stop`` the last mark's step
    raises ``Done``: the rest of the update is not needed."""

    class Done(Exception):
        pass

    def __init__(self, module, marks=(3,), stop: bool = False):
        self.module, self.marks, self.stop = module, tuple(marks), stop
        self.n = self.marks[-1]
        self.calls, self.losses = 0, []
        self.grad, self.change = None, {}
        self._adam = module.adam_step

    def watch(self, trainer, model) -> None:
        names = {id(p): k for k, p in model.named_parameters()}
        self.trainer = trainer
        self._loss = trainer.__dict__.get("_loss_fn")
        loss_fn, adam = trainer._loss_fn, self._adam

        def loss_kept(*a, **k):
            total, aux = loss_fn(*a, **k)
            if self.calls < self.n:
                self.losses.append(float(total.detach()))
            return total, aux

        def step_kept(params, grads, *a, **k):
            self.calls += 1
            if self.calls == 1:
                self.grad = _norms(names, params, grads)
                self.p0 = [p.detach().clone() for p in params]
            adam(params, grads, *a, **k)
            if self.calls in self.marks:
                self.change[self.calls] = _norms(names, params, [
                    p.detach() - p0 for p, p0 in zip(params, self.p0)])
            if self.calls == self.n:
                del self.p0
                if self.stop:
                    raise FirstSteps.Done

        trainer._loss_fn = loss_kept
        self.module.adam_step = step_kept

    def close(self) -> None:
        self.module.adam_step = self._adam
        if self._loss is None:
            del self.trainer._loss_fn
        else:
            self.trainer._loss_fn = self._loss

    def reading(self, ranks: int = 1) -> list:
        """Per rank: its losses of the steps, the gradient norms and the
        change norms at each mark; a trainer that did the ranks' shares in
        one process (``ranks``) gives each rank its own share's losses."""
        return [{"losses": self.losses[r::ranks], "grad": self.grad,
                 "change": dict(self.change)} for r in range(ranks)]


def _norms(names, params, tensors) -> Dict[str, float]:
    return {names[id(p)]: float(torch.linalg.vector_norm(t.double()))
            for p, t in zip(params, tensors)}


def leaves(model) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def _copy(x, device=None):
    if isinstance(x, dict):
        return {k: _copy(v, device) for k, v in x.items()}
    if not torch.is_tensor(x):
        return x
    return x.detach().to(device, copy=True) if device else x.detach().clone()


def snapshot(trainer, ts, epochs: int, keep_rollout_on=None):
    """Drive ``trainer`` from ``ts`` through ``epochs`` epochs with its
    ``train_epoch``: (ts, Snapshot). The program's side and the
    reference's take the same snapshot; the program's keeps its first
    rollout on the host (``keep_rollout_on``), off the card's peak."""
    rollout, first = trainer.rollout, {}

    def kept(*a, **k):
        out = rollout(*a, **k)
        if not first:
            first.update(traj=_copy(out[1]._asdict(), keep_rollout_on),
                         last_value=_copy(out[2], keep_rollout_on))
        return out

    trainer.rollout = kept
    try:
        p0, p1, losses, m1, lr1 = leaves(ts.model), None, [], None, None
        metrics1 = {}
        for e in range(epochs):
            ts, m = trainer.train_epoch(ts)
            losses.append(m["loss"])
            if e == 0:
                m1 = {k: v.detach().clone()
                      for k, v in ts.adam["m"].items()}
                p1, lr1 = leaves(ts.model), float(ts.lr)
                metrics1 = {k: float(m[k]) for k in ppo_mod.METRICS}
    finally:
        del trainer.rollout
    return ts, Snapshot([float(x) for x in losses], m1, p0, p1,
                        leaves(ts.model), first["traj"],
                        first["last_value"], lr1, metrics1)


def first_rollout(params: Dict[str, Any], seed: int, device,
                  ranks: int = 1):
    """The reference's own first rollout from ``seed``, and nothing of the
    update: (trainer, its state from ``init``, the rollout's fields,
    bootstrap values). The rollout leaves the parameters as they were, so
    ``replay`` can start from the same trainer and state (``start``)."""
    trainer = build(params, device, ranks)
    ts0 = trainer.init(seed)
    _, traj, last_value = trainer.rollout(ts0)
    return trainer, ts0, traj._asdict(), last_value


def replay(params: Dict[str, Any], seed: int, device, rollout: Dict[str, Any],
           last_value: torch.Tensor, start=None) -> Snapshot:
    """The reference's first epoch from ``seed`` with its rollout replaced
    by another's (``Snapshot.rollout``, ``last_value``): its GAE, running
    stats, dataset and update on that rollout. This follows the program
    a step from the program's own rollout, where a rounding difference
    can flip an env's exit and part its trajectory from the reference's
    own; the rollout itself is compared against the reference's own.
    ``start`` = (trainer, state) from ``first_rollout`` saves a build and
    an ``init``."""
    if start is None:
        trainer = build(params, device)
        start = trainer, trainer.init(seed)
    trainer, ts0 = start
    traj = ppo_mod.Rollout(**_copy(rollout, device))
    trainer.rollout = lambda ts: (ts, traj, _copy(last_value, device))
    return snapshot(trainer, ts0, 1)[1]


def plant_half_batch(trainer) -> None:
    """A fault, for the control readings: each minibatch's loss is the
    mean over its first half alone (the second half left out)."""
    if hasattr(trainer, "fused_task"):
        update, nmb = trainer.update, trainer.num_minibatches

        def halved(x):
            if not torch.is_tensor(x) or x.dim() == 0 \
                    or x.shape[0] != trainer.batch_size:
                return x
            v = x.reshape((nmb, -1) + tuple(x.shape[1:]))
            h = v[:, :v.shape[1] // 2]
            return torch.cat([h, h], 1).reshape(x.shape)

        trainer.update = lambda ts, dataset: update(
            ts, {k: halved(v) for k, v in dataset.items()})
        return
    loss_fn = trainer._loss_fn

    def half_loss(model, obs_rms, value_rms, mb):
        n = mb["actions"].shape[0]

        def cut(x):
            if isinstance(x, dict):
                return {k: cut(v) for k, v in x.items()}
            if torch.is_tensor(x) and x.dim() and x.shape[0] == n:
                return x[:n // 2]
            return x

        total, aux = loss_fn(model, obs_rms, value_rms, cut(mb))
        for k in ("mu", "sigma"):
            aux[k] = torch.cat([aux[k], aux[k]])
        return total, aux

    trainer._loss_fn = half_loss


def follow(params: Dict[str, Any], seed: int, epochs: int, device,
           tf32: bool = False, fault=None, ranks: int = 1,
           steps: FirstSteps = None) -> Snapshot:
    """The reference's first ``epochs`` epochs from ``seed``; with
    ``tf32`` its float32 products run in TF32 (the control); ``fault``
    plants a fault (``plant_half_batch``) for the control readings;
    ``ranks`` as in ``build``; ``steps`` watches the first update."""
    trainer = build(params, device, ranks)
    if fault is not None:
        fault(trainer)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        ts = trainer.init(seed)
        if steps is not None:
            steps.watch(trainer, ts.model)
        return snapshot(trainer, ts, epochs)[1]
    finally:
        if steps is not None:
            steps.close()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
