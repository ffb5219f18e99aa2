"""Fused PPO update phase: all mini_epochs x nmb minibatch Adam steps in
one call (counterpart of airgym_tpu/ops/fused_update.py).

``fused_update`` launches ``csrc/fused_update.cu`` for CUDA tensors (one
persistent cooperative kernel runs every Adam step of the call) and runs
``fused_update_plain`` for CPU tensors. The plain version repeats the
kernel's arithmetic: it is a loop over the same hand-derived forward and
backward, not autograd.

Semantics (rl/ppo.update of the reference trainer): clipped surrogate,
critic MSE (no value clip), bounds loss, entropy term; global grad-norm
clip ``min(1, g / max(n, 1e-6))``; optax Adam with lr folded in after the
bias-corrected update and one shared step count; the per-minibatch mu /
sigma write-back that later mini-epochs take their KL from; the adaptive
lr at each mini-epoch end; metrics averaged over the last mini-epoch.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple

import torch

from airgym_tpu_torch.kernels import build

ACT = 4
H0, H1, H2 = 64, 128, 64
KERNEL_OBS = (18, 48)        # widths csrc/fused_update.cu is built for
B1, B2, EPS = 0.9, 0.999, 1e-8
LOG2PI = float(math.log(2.0 * math.pi))
METRICS = ("loss", "kl", "a_loss", "c_loss", "b_loss", "entropy",
           "clip_frac")


class UpdatePack(NamedTuple):
    """Weights (or Adam moments), feature-major; head = [mu(4); value]."""
    w0: torch.Tensor        # [H0, obs]
    b0: torch.Tensor        # [H0, 1]
    w1: torch.Tensor        # [H1, H0]
    b1: torch.Tensor
    w2: torch.Tensor        # [H2, H1]
    b2: torch.Tensor
    wh: torch.Tensor        # [ACT + 1, H2]
    bh: torch.Tensor        # [ACT + 1, 1]
    logstd: torch.Tensor    # [ACT, 1]


_FIELDS = list(UpdatePack._fields)


def shapes(obs: int) -> Dict[str, tuple]:
    """Field shapes at ``obs`` observation features."""
    return dict(w0=(H0, obs), b0=(H0, 1), w1=(H1, H0), b1=(H1, 1),
                w2=(H2, H1), b2=(H2, 1), wh=(ACT + 1, H2), bh=(ACT + 1, 1),
                logstd=(ACT, 1))


def num_params(obs: int) -> int:
    """Flat parameter count: 18,121 at 18 features, 20,041 at 48."""
    return sum(math.prod(s) for s in shapes(obs).values())


def pack_update(tree: Dict[str, torch.Tensor]) -> UpdatePack:
    """Named tensors in the reference .pth layout (``actor_mlp.layers.N.*``,
    ``mu.*``, ``value_head.*``, ``logstd``) -> UpdatePack. The model's
    parameters and the Adam moments share these names."""
    t = lambda k: tree[k].detach().to(torch.float32)
    col = lambda k: t(k).reshape(-1, 1)
    mlp = "actor_mlp.layers"
    return UpdatePack(
        w0=t(f"{mlp}.0.weight"), b0=col(f"{mlp}.0.bias"),
        w1=t(f"{mlp}.1.weight"), b1=col(f"{mlp}.1.bias"),
        w2=t(f"{mlp}.2.weight"), b2=col(f"{mlp}.2.bias"),
        wh=torch.cat([t("mu.weight"), t("value_head.weight")], dim=0),
        bh=torch.cat([col("mu.bias"), col("value_head.bias")], dim=0),
        logstd=col("logstd"))


def unpack_update(pack: UpdatePack) -> Dict[str, torch.Tensor]:
    """UpdatePack -> named tensors (inverse of ``pack_update``)."""
    mlp = "actor_mlp.layers"
    return {
        f"{mlp}.0.weight": pack.w0, f"{mlp}.0.bias": pack.b0[:, 0],
        f"{mlp}.1.weight": pack.w1, f"{mlp}.1.bias": pack.b1[:, 0],
        f"{mlp}.2.weight": pack.w2, f"{mlp}.2.bias": pack.b2[:, 0],
        "mu.weight": pack.wh[:ACT], "mu.bias": pack.bh[:ACT, 0],
        "value_head.weight": pack.wh[ACT:], "value_head.bias": pack.bh[ACT:, 0],
        "logstd": pack.logstd[:, 0],
    }


def flatten(pack: UpdatePack) -> torch.Tensor:
    return torch.cat([x.reshape(-1) for x in pack]).contiguous()


def unflatten(flat: torch.Tensor, obs: int) -> UpdatePack:
    out, off = [], 0
    for f in _FIELDS:
        shape = shapes(obs)[f]
        size = math.prod(shape)
        out.append(flat[off:off + size].reshape(shape))
        off += size
    return UpdatePack(*out)


class _UpdateArgs(ctypes.Structure):
    """Mirror of ``struct UpdateArgs`` in csrc/fused_update.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "params", "m", "v", "lr", "count", "metrics", "mus", "sig",
        "partials", "grad", "obs", "act", "adv", "ret", "nlp_old")]
        + [(n, ctypes.c_int) for n in (
            "obs_dim", "batch", "nmb", "mini_epochs", "truncate_grads",
            "adaptive_lr", "grid")]
        + [(n, ctypes.c_float) for n in (
            "clip_lo", "clip_hi", "e_clip", "inv_mb", "critic_inv",
            "bounds_inv", "half_critic", "bounds_coef", "entropy_coef",
            "grad_norm", "kl_threshold", "min_lr", "max_lr")])


KERNEL = build.CudaKernel("fused_update", {
    "fused_update_launch": [ctypes.POINTER(_UpdateArgs), ctypes.c_void_p],
    "fused_update_partials_stride": [ctypes.c_int],
    "fused_update_grid": [ctypes.c_int, ctypes.c_int,
                          ctypes.POINTER(ctypes.c_int)]})

# at most this many persistent blocks per update call (the card gives
# SMs x resident blocks per SM: 132 on an H100)
GRID_CAP = 128
_grids: Dict[tuple, int] = {}


def grid_size(obs: int, device: torch.device) -> int:
    """Blocks of the persistent update kernel at ``obs`` features on
    ``device``: SMs x resident blocks per SM, at most ``GRID_CAP``; raises
    if the card can hold none."""
    key = (device.index, obs, GRID_CAP)
    if key not in _grids:
        g = ctypes.c_int(0)
        with torch.cuda.device(device):
            KERNEL.call("fused_update_grid", obs, GRID_CAP, ctypes.byref(g))
        _grids[key] = g.value
    return _grids[key]


def _check(obs_n, actions, adv, returns, neglogp, mus0, sigma0, packs,
           lr, count, nmb):
    dev = obs_n.device
    B = obs_n.shape[0]
    obs = obs_n.shape[1] if obs_n.dim() == 2 else -1
    want = {"obs_n": (obs_n, (B, obs)), "actions": (actions, (B, ACT)),
            "adv": (adv, (B,)), "returns": (returns, (B,)),
            "neglogp": (neglogp, (B,)), "mus0": (mus0, (B, ACT)),
            "sigma0": (sigma0, (ACT, 1)), "lr": (lr, (1,)),
            "count": (count, (1,))}
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape or x.dtype != torch.float32 \
                or x.device != dev:
            raise ValueError(f"{name}: want float32 {shape} on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if tuple(packs[0].w0.shape[1:]) != (obs,):
        raise ValueError(f"obs_n has {obs} features but UpdatePack.w0 is "
                         f"{tuple(packs[0].w0.shape)}")
    for pack in packs:
        for f, shape in shapes(obs).items():
            x = getattr(pack, f)
            if tuple(x.shape) != shape or x.dtype != torch.float32 \
                    or x.device != dev:
                raise ValueError(f"UpdatePack.{f}: want float32 "
                                 f"{shape} on {dev}")
    if nmb <= 0 or B % nmb:
        raise ValueError(f"batch {B} does not split into {nmb} minibatches")


def fused_update(obs_n, actions, adv, returns, neglogp, mus0, sigma0,
                 pack: UpdatePack, m_pack: UpdatePack, v_pack: UpdatePack,
                 lr, count, *, nmb: int, mini_epochs: int, cfg: dict):
    """Run the whole update phase.

    obs_n [B, obs] normalized observations (the kernel is built for
    obs in ``KERNEL_OBS``, the plain version takes any width);
    actions [B, ACT];
    adv/returns/neglogp [B]; mus0 [B, ACT] rollout means (first-visit KL
    reference); sigma0 [ACT, 1] rollout sigma; pack/m_pack/v_pack weights
    and Adam moments; lr [1]; count [1] (Adam steps so far).

    Returns (pack', m', v', lr', count', metrics dict of 0-d tensors); the
    inputs are not modified.
    """
    _check(obs_n, actions, adv, returns, neglogp, mus0, sigma0,
           (pack, m_pack, v_pack), lr, count, nmb)
    if not obs_n.is_cuda:
        return fused_update_plain(obs_n, actions, adv, returns, neglogp,
                                  mus0, sigma0, pack, m_pack, v_pack, lr,
                                  count, nmb=nmb, mini_epochs=mini_epochs,
                                  cfg=cfg)
    B, obs = obs_n.shape
    if obs not in KERNEL_OBS:
        raise ValueError(f"the update kernel is built for {KERNEL_OBS} "
                         f"observation features, got {obs}")
    dev = obs_n.device
    return _kernel_update(KERNEL, grid_size(obs, dev),
                          torch.cuda.current_stream(dev).cuda_stream, obs_n,
                          actions, adv, returns, neglogp, mus0, sigma0, pack,
                          m_pack, v_pack, lr, count, nmb=nmb,
                          mini_epochs=mini_epochs, cfg=cfg)


def _kernel_update(kernel, grid, stream, obs_n, actions, adv, returns,
                   neglogp, mus0, sigma0, pack, m_pack, v_pack, lr, count, *,
                   nmb, mini_epochs, cfg):
    """One launch of ``kernel``'s ``fused_update_launch`` with ``grid``
    blocks on ``stream``, its buffers on ``obs_n``'s device (a CPU build of
    the source takes CPU tensors and no stream)."""
    dev = obs_n.device
    B, obs = obs_n.shape
    mb = B // nmb
    stride = kernel.lib().fused_update_partials_stride(obs)
    f32 = dict(dtype=torch.float32, device=dev)
    # the kernel stages the parameters as float4: pad them to a multiple
    # of 4 floats
    n = num_params(obs)
    params = torch.zeros(-(-n // 4) * 4, **f32)
    params[:n] = flatten(pack)
    m, v = flatten(m_pack), flatten(v_pack)
    lr_b, count_b = lr.clone(), count.clone()
    met = torch.zeros(8, **f32)
    mus = mus0.contiguous().clone()
    sig = sigma0.reshape(1, ACT).repeat(nmb, 1).contiguous()
    partials = torch.empty(grid * stride, **f32)
    grad = torch.empty(n, **f32)
    data = [x.contiguous() for x in (obs_n, actions, adv, returns, neglogp)]
    ptr = lambda x: x.data_ptr()
    inv = 1.0 / mb
    args = _UpdateArgs(
        ptr(params), ptr(m), ptr(v), ptr(lr_b), ptr(count_b), ptr(met),
        ptr(mus), ptr(sig), ptr(partials), ptr(grad),
        *[ptr(x) for x in data],
        obs, B, nmb, mini_epochs, int(bool(cfg["truncate_grads"])),
        int(bool(cfg["adaptive_lr"])), grid,
        1.0 - cfg["e_clip"], 1.0 + cfg["e_clip"], cfg["e_clip"], inv,
        cfg["critic_coef"] * inv, cfg["bounds_coef"] * inv,
        0.5 * cfg["critic_coef"], cfg["bounds_coef"], cfg["entropy_coef"],
        cfg["grad_norm"], cfg["kl_threshold"], cfg["min_lr"], cfg["max_lr"])
    kernel.call("fused_update_launch", ctypes.byref(args), stream)
    kernel.launches[f"obs{obs}"] += 1
    metrics = {k: met[i] for i, k in enumerate(METRICS)}
    return (unflatten(params, obs), unflatten(m, obs), unflatten(v, obs),
            lr_b, count_b, metrics)


def fused_update_plain(obs_n, actions, adv, returns, neglogp, mus0, sigma0,
                       pack: UpdatePack, m_pack: UpdatePack,
                       v_pack: UpdatePack, lr, count, *, nmb: int,
                       mini_epochs: int, cfg: dict):
    """Plain PyTorch version of ``csrc/fused_update.cu``; the
    observation width comes from ``obs_n``."""
    B, obs = obs_n.shape
    mb = B // nmb
    W = [x.clone() for x in pack]
    M = [x.clone() for x in m_pack]
    V = [x.clone() for x in v_pack]
    lr, t = lr.clone(), count.clone()
    log_b1 = torch.log(torch.tensor(B1, dtype=torch.float32,
                                    device=obs_n.device))
    log_b2 = torch.log(torch.tensor(B2, dtype=torch.float32,
                                    device=obs_n.device))
    fm = lambda x, f: x.reshape(nmb, mb, f).transpose(1, 2)
    obs_d, act_d = fm(obs_n, obs), fm(actions, ACT)
    adv_d, ret_d, nlp_d = (x.reshape(nmb, 1, mb) for x in
                           (adv, returns, neglogp))
    mus_store = fm(mus0, ACT).clone()                  # [nmb, ACT, mb]
    sig_store = sigma0[None].repeat(nmb, 1, 1)         # [nmb, ACT, 1]
    acc = torch.zeros(8, dtype=torch.float32, device=obs_n.device)
    e_clip = cfg["e_clip"]
    inv = 1.0 / mb

    def elu(z):
        return torch.where(z > 0, z, torch.exp(torch.clamp_max(z, 0.0)) - 1.0)

    def delu(z, h):
        return torch.where(z > 0, torch.ones_like(h), h + 1.0)

    for e in range(mini_epochs):
        for i in range(nmb):
            w0, b0, w1, b1, w2, b2, wh, bh, logstd = W
            x, a = obs_d[i], act_d[i]
            adv_i, ret, nlp_old = adv_d[i], ret_d[i], nlp_d[i]

            z0 = w0 @ x + b0
            h0 = elu(z0)
            z1 = w1 @ h0 + b1
            h1 = elu(z1)
            z2 = w2 @ h1 + b2
            h2 = elu(z2)
            out = wh @ h2 + bh
            mu = out[:ACT]
            v = out[ACT:ACT + 1]
            sigma = torch.exp(logstd)
            ls = logstd[:, 0]
            lsum = ((ls[0] + ls[1]) + ls[2]) + ls[3]

            d = (a - mu) / sigma
            dd = d * d
            nlp = (0.5 * (((dd[0:1] + dd[1:2]) + dd[2:3]) + dd[3:4])
                   + 0.5 * LOG2PI * ACT) + lsum
            ratio = torch.exp(nlp_old - nlp)
            clamped = torch.clamp(ratio, 1.0 - e_clip, 1.0 + e_clip)
            n_s1 = -adv_i * ratio
            n_s2 = -adv_i * clamped
            a_loss = torch.maximum(n_s1, n_s2)
            verr = v - ret
            c_loss = verr * verr
            mu_hi = torch.clamp_min(mu - 1.1, 0.0)
            mu_lo = torch.clamp_max(mu + 1.1, 0.0)
            b_loss = torch.sum(mu_hi * mu_hi + mu_lo * mu_lo, dim=0,
                               keepdim=True)
            ent = lsum + 0.5 * ACT * (1.0 + LOG2PI)

            use1 = (n_s1 >= n_s2).to(torch.float32)
            inclip = ((ratio > 1.0 - e_clip) & (ratio < 1.0 + e_clip)) \
                .to(torch.float32)
            dnlp = inv * (use1 * adv_i * ratio
                          + (1.0 - use1) * adv_i * ratio * inclip)
            dmu = dnlp * (-d / sigma)
            dmu = dmu + (cfg["bounds_coef"] * inv) * (2.0 * mu_hi
                                                      + 2.0 * mu_lo)
            dv = (cfg["critic_coef"] * inv) * verr
            dlogstd = (torch.sum(dnlp * (1.0 - d * d), dim=1, keepdim=True)
                       - cfg["entropy_coef"])

            dout = torch.cat([dmu, dv], dim=0)
            dwh = dout @ h2.T
            dbh = torch.sum(dout, dim=1, keepdim=True)
            dz2 = (wh.T @ dout) * delu(z2, h2)
            dw2 = dz2 @ h1.T
            db2 = torch.sum(dz2, dim=1, keepdim=True)
            dz1 = (w2.T @ dz2) * delu(z1, h1)
            dw1 = dz1 @ h0.T
            db1 = torch.sum(dz1, dim=1, keepdim=True)
            dz0 = (w1.T @ dz1) * delu(z0, h0)
            dw0 = dz0 @ x.T
            db0 = torch.sum(dz0, dim=1, keepdim=True)
            grads = [dw0, db0, dw1, db1, dw2, db2, dwh, dbh, dlogstd]

            if cfg["truncate_grads"]:
                gsq = sum(torch.sum(gr * gr) for gr in grads)
                gn = torch.sqrt(gsq)
                scale = torch.clamp_max(
                    cfg["grad_norm"] / torch.clamp_min(gn, 1e-6), 1.0)
                grads = [gr * scale for gr in grads]

            t = t + 1.0
            bc1 = 1.0 - torch.exp(t * log_b1)
            bc2 = 1.0 - torch.exp(t * log_b2)
            for k in range(len(W)):
                M[k] = B1 * M[k] + (1.0 - B1) * grads[k]
                V[k] = B2 * V[k] + (1.0 - B2) * (grads[k] * grads[k])
                upd = (M[k] / bc1) / (torch.sqrt(V[k] / bc2) + EPS)
                W[k] = W[k] - lr * upd

            mu_old, sig_old = mus_store[i], sig_store[i]
            kl_e = (torch.log(sigma / sig_old + 1e-7)
                    + (sig_old * sig_old + (mu - mu_old) * (mu - mu_old))
                    / (2.0 * sigma * sigma + 1e-7) - 0.5)
            kl = torch.mean(torch.sum(kl_e, dim=0))
            mus_store[i] = mu
            sig_store[i] = sigma
            clip_frac = torch.mean((torch.abs(ratio - 1.0) > e_clip)
                                   .to(torch.float32))
            total = (torch.mean(a_loss)
                     + 0.5 * cfg["critic_coef"] * torch.mean(c_loss)
                     - cfg["entropy_coef"] * ent
                     + cfg["bounds_coef"] * torch.mean(b_loss))
            if i == 0:
                acc.zero_()
            acc += torch.stack([total, kl, torch.mean(a_loss),
                                torch.mean(c_loss), torch.mean(b_loss), ent,
                                clip_frac, torch.zeros_like(kl)])
            if i == nmb - 1 and cfg["adaptive_lr"]:
                av_kl = acc[1] / nmb
                thr = cfg["kl_threshold"]
                lr1 = torch.where(av_kl > 2.0 * thr,
                                  torch.clamp_min(lr / 1.5, cfg["min_lr"]),
                                  lr)
                lr = torch.where(av_kl < 0.5 * thr,
                                 torch.clamp_max(lr1 * 1.5, cfg["max_lr"]),
                                 lr1)

    metrics = {k: acc[j] / nmb for j, k in enumerate(METRICS)}
    return (UpdatePack(*W), UpdatePack(*M), UpdatePack(*V), lr, t, metrics)
