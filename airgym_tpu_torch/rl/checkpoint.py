"""Checkpoints (counterpart of airgym_tpu/rl/checkpoint.py).

* Native format: a torch file of plain tensors and numbers (``save`` /
  ``load`` / ``restore``): the model state dict, the running stats (a
  dict {'image', 'observation'} of them for camera tasks), the Adam
  moments and count, lr, epoch and frame, and the per-actor success
  trackers of the last finished episodes (``last_ep_success``,
  ``last_ep_env_success``) where the task has them. The env state is not
  saved; a resumed run re-initializes its envs, as the reference does.
* ``export_pth`` / ``import_pth``: the reference .pth layout
  (``model`` = actor_mlp.layers.N.*, mu.*, value_head.*, logstd, the CNN's
  actor_cnn.features.{0,3,6} convs, .features.{2,5,8} batch norms and
  actor_cnn.fc, running_mean_std.* or, for dict obs,
  running_mean_std.running_mean_std.{image,observation}.*, and
  value_mean_std.*, stats in float64), which the JAX package's
  ``import_pth`` / ``export_pth`` also read and write. ``restore_pth``
  resumes from one: parameters, stats, epoch and frame.
* ``from_jax``: carries a JAX TrainState's parameters, running stats and
  Adam state, given as numpy pytrees, into the native format (flax HWIO
  conv kernels become torch OIHW).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from airgym_tpu_torch.rl.running_stats import RunningMeanStd


def _rms_payload(rms):
    if rms is None:
        return None
    if isinstance(rms, dict):
        return {k: _rms_payload(r) for k, r in rms.items()}
    return {k: getattr(rms, k).detach().cpu() for k in ("mean", "var", "count")}


def _rms_from_payload(d, device):
    if d is None:
        return None
    if "mean" not in d:                      # dict obs: one entry per key
        return {k: _rms_from_payload(r, device) for k, r in d.items()}
    return RunningMeanStd(*(d[k].to(device=device, dtype=torch.float64)
                            for k in ("mean", "var", "count")))


# success trackers [N] of the TrainState, for tasks with has_success /
# has_env_success
_TRACKERS = ("last_ep_success", "last_ep_env_success")


def payload(ts) -> Dict[str, Any]:
    """TrainState -> the native checkpoint dict (CPU tensors)."""
    cpu = lambda d: {k: v.detach().cpu().clone() for k, v in d.items()}
    return {
        "model": cpu(ts.model.state_dict()),
        "obs_rms": _rms_payload(ts.obs_rms),
        "value_rms": _rms_payload(ts.value_rms),
        "adam": {"m": cpu(ts.adam["m"]), "v": cpu(ts.adam["v"]),
                 "count": ts.adam["count"].detach().cpu().clone()},
        "lr": float(ts.lr),
        "epoch": int(ts.epoch),
        "frame": int(ts.frame),
        "adv_ms": (None if ts.adv_ms is None
                   else [x.detach().cpu() for x in ts.adv_ms]),
        **{k: (None if getattr(ts, k) is None
               else getattr(ts, k).detach().cpu().clone())
           for k in _TRACKERS},
    }


def save(path: str, ts) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(payload(ts), path)


def load(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


def restore(ts, ck: Dict[str, Any]):
    """Apply a native checkpoint dict to a TrainState (env state kept)."""
    dev = ts.lr.device
    ts.model.load_state_dict(ck["model"])
    to = lambda d: {k: v.to(dev) for k, v in d.items()}
    adam = ck.get("adam")
    if adam is not None:
        adam = {"m": to(adam["m"]), "v": to(adam["v"]),
                "count": adam["count"].to(device=dev,
                                          dtype=torch.float32).reshape(1)}
    else:
        adam = ts.adam
    adv_ms = ts.adv_ms
    if ck.get("adv_ms") is not None and adv_ms is not None:
        adv_ms = type(adv_ms)(*(x.to(dev) for x in ck["adv_ms"]))
    # a tracker the task has and the checkpoint lacks starts at zero; one
    # the task does not have is dropped (the JAX runner's restore)
    trackers = {}
    for k in _TRACKERS:
        have, saved = getattr(ts, k, None), ck.get(k)
        if have is not None:
            trackers[k] = (torch.zeros_like(have) if saved is None
                           else saved.to(have).reshape(have.shape))
    return dataclasses.replace(
        ts, adam=adam, adv_ms=adv_ms, **trackers,
        obs_rms=_rms_from_payload(ck.get("obs_rms"), dev) or ts.obs_rms,
        value_rms=_rms_from_payload(ck.get("value_rms"), dev) or ts.value_rms,
        lr=torch.tensor(ck.get("lr", float(ts.lr)), dtype=torch.float32,
                        device=dev),
        epoch=int(ck.get("epoch", 0)), frame=int(ck.get("frame", 0)))


# ---------------------------------------------------------------------------
# reference .pth layout


def _rms_to_ref(rms: RunningMeanStd, prefix: str, out: Dict[str, Any]):
    # 0-d stats travel as [1], as numpy's ascontiguousarray makes them
    for k, key in (("mean", "running_mean"), ("var", "running_var"),
                   ("count", "count")):
        v = getattr(rms, k).detach().to("cpu", torch.float64)
        out[f"{prefix}.{key}"] = v.reshape(1) if v.dim() == 0 else v


def model_state_dict(model, obs_rms=None, value_rms=None) -> Dict[str, Any]:
    out = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    if value_rms is not None:
        _rms_to_ref(value_rms, "value_mean_std", out)
    if isinstance(obs_rms, dict):
        for key, rms in obs_rms.items():
            _rms_to_ref(rms, f"running_mean_std.running_mean_std.{key}", out)
    elif obs_rms is not None:
        _rms_to_ref(obs_rms, "running_mean_std", out)
    return out


def export_pth(path: str, ts, last_mean_rewards: float = -1e9) -> None:
    """Write a reference-layout .pth (reference torch_ext.load_checkpoint
    and the JAX package's import_pth read it)."""
    state = {
        "model": model_state_dict(ts.model, ts.obs_rms, ts.value_rms),
        "epoch": int(ts.epoch),
        "frame": int(ts.frame),
        "optimizer": {"state": {}, "param_groups": []},
        "last_mean_rewards": float(last_mean_rewards),
        "env_state": None,
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(state, path)


def import_pth(path: str, model, obs_rms=None, value_rms=None):
    """Load a reference .pth into ``model`` (in place); returns the
    (obs_rms, value_rms, meta) it carries, or the given ones where it
    has none."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: torch.as_tensor(v) for k, v in ck["model"].items()}
    own = model.state_dict()
    model.load_state_dict({k: sd[k].to(own[k].dtype).reshape(own[k].shape)
                           for k in own})

    def rms(prefix, template):
        if template is None or f"{prefix}.running_mean" not in sd:
            return template
        dev = template.mean.device
        f = lambda key, shape: sd[f"{prefix}.{key}"].to(
            device=dev, dtype=torch.float64).reshape(shape)
        return RunningMeanStd(f("running_mean", template.mean.shape),
                              f("running_var", template.var.shape),
                              f("count", ()))

    meta = {"epoch": int(ck.get("epoch", 0)), "frame": int(ck.get("frame", 0)),
            "last_mean_rewards": float(ck.get("last_mean_rewards", -1e9))}
    if isinstance(obs_rms, dict):
        obs_rms = {k: rms(f"running_mean_std.running_mean_std.{k}", r)
                   for k, r in obs_rms.items()}
    else:
        obs_rms = rms("running_mean_std", obs_rms)
    return obs_rms, rms("value_mean_std", value_rms), meta


def restore_pth(ts, path: str):
    """Resume a TrainState from a reference .pth: its parameters, running
    stats, epoch and frame. The file carries no optimizer state, so Adam
    and lr stay as ``init`` made them (the JAX runner's .pth resume)."""
    obs_rms, value_rms, meta = import_pth(path, ts.model, ts.obs_rms,
                                          ts.value_rms)
    return dataclasses.replace(ts, obs_rms=obs_rms, value_rms=value_rms,
                               epoch=meta["epoch"], frame=meta["frame"])


# ---------------------------------------------------------------------------
# JAX -> port


def _get(x, name):
    return x[name] if isinstance(x, dict) else getattr(x, name)


_BN_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def _jax_params_to_ref(p) -> Dict[str, torch.Tensor]:
    """flax ActorCritic params (numpy) -> reference-layout tensors (with
    the CNN's batch-norm statistics, which flax keeps as parameters)."""
    p = p.get("params", p)
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    out = {}
    if "actor_cnn" in p:
        cnn = p["actor_cnn"]
        for i, (ci, bi) in enumerate(((0, 2), (3, 5), (6, 8))):
            c, b = cnn[f"conv{i}"], cnn[f"bn{i}"]
            pre = "actor_cnn.features"
            # flax HWIO -> torch OIHW
            out[f"{pre}.{ci}.weight"] = t(c["kernel"]).permute(3, 2, 0, 1)
            out[f"{pre}.{ci}.bias"] = t(c["bias"])
            out[f"{pre}.{bi}.weight"] = t(b["scale"])
            out[f"{pre}.{bi}.bias"] = t(b["bias"])
            out[f"{pre}.{bi}.running_mean"] = t(b["mean"])
            out[f"{pre}.{bi}.running_var"] = t(b["var"])
            out[f"{pre}.{bi}.num_batches_tracked"] = torch.zeros(
                (), dtype=torch.int64)
        out["actor_cnn.fc.weight"] = t(cnn["fc"]["kernel"]).T
        out["actor_cnn.fc.bias"] = t(cnn["fc"]["bias"])
    mlp = p["actor_mlp"]
    for i in range(len(mlp)):
        out[f"actor_mlp.layers.{i}.weight"] = t(mlp[f"Dense_{i}"]["kernel"]).T
        out[f"actor_mlp.layers.{i}.bias"] = t(mlp[f"Dense_{i}"]["bias"])
    out["mu.weight"] = t(p["mu"]["kernel"]).T
    out["mu.bias"] = t(p["mu"]["bias"])
    out["value_head.weight"] = t(p["value"]["kernel"]).T
    out["value_head.bias"] = t(p["value"]["bias"])
    out["logstd"] = t(p["logstd"])
    return {k: v.contiguous() for k, v in out.items()}


def _jax_rms(rms) -> Optional[Dict[str, torch.Tensor]]:
    """Fold each field with its Neumaier carry into float64."""
    if rms is None:
        return None
    if isinstance(rms, dict):
        return {k: _jax_rms(r) for k, r in rms.items()}

    def full(name):
        v = np.asarray(_get(rms, name), np.float64)
        try:
            c = _get(rms, name + "_c")
        except (KeyError, AttributeError):
            c = None
        if c is not None:
            v = v + np.asarray(c, np.float64)
        return torch.from_numpy(np.asarray(v))

    return {"mean": full("mean"), "var": full("var"),
            "count": full("count").reshape(())}


def from_jax(params_np, obs_rms_np, value_rms_np, adam_np=None,
             lr: Optional[float] = None, last_ep_success=None,
             last_ep_env_success=None) -> Dict[str, Any]:
    """A JAX TrainState's pieces (numpy pytrees: the flax params, the
    RunningMeanStd tuples, and optax's ScaleByAdamState with ``count``,
    ``mu``, ``nu``; the success trackers as numpy arrays, where the JAX
    TrainState has them) -> a native checkpoint dict for ``restore``."""
    tracker = lambda a: (None if a is None else torch.from_numpy(
        np.array(a, dtype=np.float32)))
    ck: Dict[str, Any] = {
        "model": _jax_params_to_ref(params_np),
        "obs_rms": _jax_rms(obs_rms_np),
        "value_rms": _jax_rms(value_rms_np),
        "epoch": 0, "frame": 0,
        "last_ep_success": tracker(last_ep_success),
        "last_ep_env_success": tracker(last_ep_env_success),
    }
    if adam_np is not None:
        # the batch-norm statistics are buffers here, not parameters
        moments = lambda tree: {
            k: v for k, v in _jax_params_to_ref(tree).items()
            if k.rsplit(".", 1)[-1] not in _BN_BUFFERS}
        ck["adam"] = {
            "m": moments(_get(adam_np, "mu")),
            "v": moments(_get(adam_np, "nu")),
            "count": torch.tensor([float(np.asarray(_get(adam_np, "count")))],
                                  dtype=torch.float32)}
    if lr is not None:
        ck["lr"] = float(lr)
    return ck
