"""Checkpoints (counterpart of airgym_tpu/rl/checkpoint.py).

* Native format: a torch file of plain tensors and numbers (``save`` /
  ``load`` / ``restore``): the model state dict, the running stats (a
  dict {'image', 'observation'} of them for camera tasks), the Adam
  moments and count, lr, epoch and frame, and the per-actor success
  trackers of the last finished episodes (``last_ep_success``,
  ``last_ep_env_success``) where the task has them. The env state is not
  saved; a resumed run re-initializes its envs, as the reference does.
* ``export_pth`` / ``import_pth``: the reference .pth layout
  (``model`` = actor_mlp.layers.N.*, critic_mlp.layers.N.* with
  ``separate``, mu.*, value_head.*, logstd or, with ``fixed_sigma:
  False``, logstd.weight / logstd.bias, the CNN's
  actor_cnn.features.{0,3,6} convs, .features.{2,5,8} batch norms and
  actor_cnn.fc, running_mean_std.* or, for dict obs,
  running_mean_std.running_mean_std.{image,observation}.*, and
  value_mean_std.*, stats in float64), which the JAX package's
  ``import_pth`` / ``export_pth`` also read and write. ``restore_pth``
  resumes from one: parameters, stats, epoch and frame. The VAE and
  ResNet encoders are not in the .pth, as in the JAX package's: an
  import keeps the model's own (the pretrained file's graft); the native
  checkpoint carries them.
* ``from_jax``: carries a JAX TrainState's parameters, running stats and
  Adam state, given as numpy pytrees, into the native format (flax HWIO
  conv kernels become torch OIHW).
* ``transfer_obs_width``: the robot-count curriculum's warm start across
  observation-vector widths.
* ``safe_filesystem_op``: every checkpoint read and write above, and the
  runner's pretrained-encoder load, retries on ``OSError``.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from airgym_tpu_torch.models.actor_critic import ENCODER_MODULES
from airgym_tpu_torch.rl.ppo import adam_init, trainable
from airgym_tpu_torch.rl.running_stats import RunningMeanStd

# encoders the .pth leaves out (the JAX package's model_state_dict writes
# only the CNN's)
_PTH_LESS = tuple(f"{ENCODER_MODULES[e]}." for e in ("vae", "resnet"))


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


def safe_filesystem_op(fn, *args, attempts: int = 10, **kwargs):
    """``fn(*args, **kwargs)``, retried on ``OSError`` (an NFS hiccup)
    after sleeps of 0.1 * (i + 1) s; the last error is raised once the
    ``attempts`` run out (reference torch_ext.safe_filesystem_op,
    lib/core/torch_ext.py:51-66)."""
    last = None
    for i in range(attempts):
        try:
            return fn(*args, **kwargs)
        except OSError as e:
            last = e
            time.sleep(0.1 * (i + 1))
    raise last


def save(path: str, ts) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    safe_filesystem_op(torch.save, payload(ts), path)


def load(path: str) -> Dict[str, Any]:
    return safe_filesystem_op(torch.load, path, map_location="cpu",
                              weights_only=True)


def restore(ts, ck: Dict[str, Any]):
    """Apply a native checkpoint dict to a TrainState (env state kept)."""
    dev = ts.lr.device
    ts.model.load_state_dict(ck["model"])
    # the moments of the parameters Adam steps (a JAX state carries the
    # frozen encoders' zeros too)
    names = trainable(ts.model)
    to = lambda d: {k: v.to(dev) for k, v in d.items() if k in names}
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
    out = {k: v.detach().cpu() for k, v in model.state_dict().items()
           if not k.startswith(_PTH_LESS)}
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
    safe_filesystem_op(torch.save, state, path)


def import_pth(path: str, model, obs_rms=None, value_rms=None):
    """Load a reference .pth into ``model`` (in place); returns the
    (obs_rms, value_rms, meta) it carries, or the given ones where it
    has none."""
    ck = safe_filesystem_op(torch.load, path, map_location="cpu",
                            weights_only=True)
    sd = {k: torch.as_tensor(v) for k, v in ck["model"].items()}
    own = model.state_dict()
    model.load_state_dict({
        k: (v if k.startswith(_PTH_LESS) and k not in sd
            else sd[k].to(v.dtype).reshape(v.shape))
        for k, v in own.items()})

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


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(c, out, prefix, bias=True):
    """flax conv params -> torch OIHW weight (and bias)."""
    out[f"{prefix}.weight"] = _t(c["kernel"]).permute(3, 2, 0, 1)
    if bias:
        out[f"{prefix}.bias"] = _t(c["bias"])


def _dense(d, out, prefix):
    out[f"{prefix}.weight"] = _t(d["kernel"]).T
    out[f"{prefix}.bias"] = _t(d["bias"])


def _bn(b, out, prefix):
    """flax FrozenBatchNorm params -> FrozenBatchNorm parameters and
    buffers."""
    out[f"{prefix}.weight"] = _t(b["scale"])
    out[f"{prefix}.bias"] = _t(b["bias"])
    out[f"{prefix}.running_mean"] = _t(b["mean"])
    out[f"{prefix}.running_var"] = _t(b["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)


_VAE_CONVS = ("conv0", "conv0_1", "conv1_0", "conv1_1", "conv2_0",
              "conv2_1", "conv3_0", "conv0_jump_2", "conv1_jump_3")


def _jax_vae_encoder_to_ref(enc, out, prefix=""):
    """flax ImgEncoder params -> ``models/vae.ImgEncoder``'s."""
    for name in _VAE_CONVS:
        _conv(enc[name], out, f"{prefix}{name}")
    for name in ("dense0", "dense1"):
        _dense(enc[name], out, f"{prefix}{name}")


def _jax_resnet_to_ref(res, out, prefix=""):
    """flax ResNet18Encoder params (``blockI``, ``downsample_conv`` /
    ``_bn``) -> ``models/resnet.ResNet18Encoder``'s torchvision names."""
    _conv(res["conv1"], out, f"{prefix}conv1", bias=False)
    _bn(res["bn1"], out, f"{prefix}bn1")
    for i in range(8):
        blk, pre = res[f"block{i}"], f"{prefix}layer{i // 2 + 1}.{i % 2}"
        for j in (1, 2):
            _conv(blk[f"conv{j}"], out, f"{pre}.conv{j}", bias=False)
            _bn(blk[f"bn{j}"], out, f"{pre}.bn{j}")
        if "downsample_conv" in blk:
            _conv(blk["downsample_conv"], out, f"{pre}.downsample.0",
                  bias=False)
            _bn(blk["downsample_bn"], out, f"{pre}.downsample.1")
    _dense(res["fc"], out, f"{prefix}fc")


def _jax_params_to_ref(p) -> Dict[str, torch.Tensor]:
    """flax ActorCritic params (numpy) -> the port's names (with the
    batch-norm statistics, which flax keeps as parameters)."""
    p = p.get("params", p)
    out = {}
    if "actor_cnn" in p:
        cnn = p["actor_cnn"]
        for i, (ci, bi) in enumerate(((0, 2), (3, 5), (6, 8))):
            _conv(cnn[f"conv{i}"], out, f"actor_cnn.features.{ci}")
            _bn(cnn[f"bn{i}"], out, f"actor_cnn.features.{bi}")
        _dense(cnn["fc"], out, "actor_cnn.fc")
    if "actor_enc" in p:
        _jax_vae_encoder_to_ref(p["actor_enc"]["vae"]["encoder"], out,
                                "actor_enc.encoder.")
    if "actor_resnet" in p:
        _jax_resnet_to_ref(p["actor_resnet"], out, "actor_resnet.")
    for trunk in ("actor_mlp", "critic_mlp"):
        for i in range(len(p.get(trunk, ()))):
            _dense(p[trunk][f"Dense_{i}"], out, f"{trunk}.layers.{i}")
    _dense(p["mu"], out, "mu")
    _dense(p["value"], out, "value_head")
    if "logstd_head" in p:
        _dense(p["logstd_head"], out, "logstd")
    else:
        out["logstd"] = _t(p["logstd"])
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
        # the batch-norm statistics are buffers here, not parameters;
        # ``restore`` keeps the moments of the parameters Adam steps
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


# ---------------------------------------------------------------------------
# warm start across observation widths


def transfer_obs_width(trainer, ts, loaded: Dict[str, Any], old_obs_dim: int,
                       new_obs_dim: int):
    """Warm-start a policy across observation-VECTOR widths (the JAX
    package's ``transfer_obs_width``).

    MAPlanning's obs vector is 16 + 2 * num_robots channels whose
    per-robot relative channels are zeroed, so a policy trained at one
    robot count transfers exactly to another: inserted first-layer inputs
    only ever see zeros (their stats start at mean 0 / var 1, normalising
    0 to 0), and removed ones only ever saw zeros.

    The MLP input is [obs_vec ++ image features], so the first layer of
    each trunk (``actor_mlp``, and ``critic_mlp`` with ``separate``) is
    re-indexed along its input axis, dim 1 of the torch [out, in] weight:
    the first min(old, new) columns, zero columns up to the new width,
    then the feature columns. The 'observation' stats are re-indexed the
    same way (``var`` padded with ones, ``count`` kept); the image stats
    must match in shape. The other parameters, ``value_rms`` and lr carry
    over; Adam starts fresh (its moments are shaped by the old input) and
    epoch and frame restart at 0.

    ``ts`` is a fresh ``trainer.init`` state of the TARGET task;
    ``loaded`` the source's native checkpoint dict (``load``)."""
    keep = min(old_obs_dim, new_obs_dim)

    def resize(x: torch.Tensor, dim: int, pad: float = 0.0) -> torch.Tensor:
        parts = [x.narrow(dim, 0, keep)]
        if new_obs_dim > keep:
            shape = list(x.shape)
            shape[dim] = new_obs_dim - keep
            parts.append(torch.full(shape, pad, dtype=x.dtype))
        parts.append(x.narrow(dim, old_obs_dim, x.shape[dim] - old_obs_dim))
        return torch.cat(parts, dim)

    sd = dict(loaded["model"])
    for trunk in ("actor_mlp", "critic_mlp"):
        k = f"{trunk}.layers.0.weight"
        if k in sd:
            sd[k] = resize(sd[k], 1)
    ts.model.load_state_dict(sd)

    def resize_stats(d):
        return {"mean": resize(d["mean"], 0), "var": resize(d["var"], 0, 1.0),
                "count": d["count"]}

    rms = loaded["obs_rms"]
    if isinstance(rms, dict) and "mean" not in rms:      # dict obs
        if "image" in rms and isinstance(ts.obs_rms, dict):
            have = tuple(ts.obs_rms["image"].mean.shape)
            if tuple(rms["image"]["mean"].shape) != have:
                raise ValueError(
                    f"transfer_obs_width only resizes the obs VECTOR; the "
                    f"image stats differ in shape "
                    f"({tuple(rms['image']['mean'].shape)} vs {have}): "
                    f"source and target must use the same camera "
                    f"resolution")
        rms = {k: resize_stats(v) if k == "observation" else v
               for k, v in rms.items()}
    elif rms is not None:
        rms = resize_stats(rms)
    dev = ts.lr.device
    return dataclasses.replace(
        ts, adam=adam_init(ts.model),
        obs_rms=_rms_from_payload(rms, dev) or ts.obs_rms,
        value_rms=_rms_from_payload(loaded.get("value_rms"), dev)
        or ts.value_rms,
        lr=torch.tensor(loaded.get("lr", float(ts.lr)), dtype=torch.float32,
                        device=dev),
        epoch=0, frame=0)
