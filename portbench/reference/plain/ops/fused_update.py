"""The fused PPO update phase's plain version: all mini_epochs x nmb
minibatch Adam steps in one call, the arithmetic of csrc/fused_update.cu.
It is a loop over the kernel's hand-derived forward and backward, not
autograd.

Semantics (rl/ppo.update of the reference trainer): clipped surrogate,
critic MSE (no value clip), bounds loss, entropy term; global grad-norm
clip ``min(1, g / max(n, 1e-6))``; optax Adam with lr folded in after the
bias-corrected update and one shared step count; the per-minibatch mu /
sigma write-back that later mini-epochs take their KL from; the adaptive
lr at each mini-epoch end; metrics averaged over the last mini-epoch.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch


ACT = 4
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


def fused_update(obs_n, actions, adv, returns, neglogp, mus0, sigma0,
                       pack: UpdatePack, m_pack: UpdatePack,
                       v_pack: UpdatePack, lr, count, *, nmb: int,
                       mini_epochs: int, cfg: dict):
    """The whole update phase -> (pack', m', v', lr', count', metrics
    dict of 0-d tensors); the inputs are not modified.

    obs_n [B, obs] normalized observations; actions [B, ACT];
    adv/returns/neglogp [B]; mus0 [B, ACT] rollout means (first-visit KL
    reference); sigma0 [ACT, 1] rollout sigma; pack/m_pack/v_pack weights
    and Adam moments; lr [1]; count [1] (Adam steps so far)."""
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
            if i == nmb - 1:
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
