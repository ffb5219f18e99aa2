"""The fused trainers' epoch preparation: GAE, the running stats and the
env-major dataset between the rollout kernel and the update kernel.

``epoch_prep`` launches ``csrc/epoch_prep.cu`` for CUDA tensors in three
launches, each inside the program span of its phase: ``gae`` (with the
wrapper's checks, buffers and launch arguments), ``stats`` and ``dataset``
(with the wrapping of the results). CPU tensors run ``epoch_prep_plain``:
the fused trainers keep ``PPO._prepare`` on the CPU, so only the tests,
which force the fused trainers onto this op, take that branch. The plain twin
repeats the kernels' arithmetic in their order: GAE, the normalisations
and the dataset rows with ``PPO.compute_gae``'s and
``RunningMeanStd``'s float32 operations, the running stats with
``RunningMeanStd.update``'s float64 ones over per-env, per-warp and
per-block partial (count, mean, M2) merged by Chan's formula, and the
advantages' mean and population std in float64 (``PPO._prepare`` takes
them in float32).

Its square roots are rounded once, as the card's are: ``torch.sqrt`` on
the CPU can be an ulp off, so the plain twin takes them through float64.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from airgym_tpu_torch.kernels import build
from airgym_tpu_torch.rl import profiling
from airgym_tpu_torch.rl.running_stats import RunningMeanStd

ACT = 4
WARP = 32                   # envs of a partial: a gae block's lanes
MAX_OBS = 61                # the stats block's 64 threads take K + 3


class Prep(NamedTuple):
    values: torch.Tensor        # [H, N] denormalised values
    adv: torch.Tensor           # [H, N] GAE advantages
    returns: torch.Tensor       # [H, N] adv + values
    obs_rms: RunningMeanStd     # the observation stats after the epoch
    value_rms: RunningMeanStd   # the value stats after the values, returns
    obs_n: torch.Tensor         # [N H, K] env-major rows, as B3 takes them
    actions: torch.Tensor       # [N H, ACT]
    neglogp: torch.Tensor       # [N H]
    mus: torch.Tensor           # [N H, ACT]
    adv_n: torch.Tensor         # [N H] normalised advantages
    returns_n: torch.Tensor     # [N H] normalised returns


class _PrepArgs(ctypes.Structure):
    """Mirror of ``struct PrepArgs`` in csrc/epoch_prep.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "rec", "last_value", "obs_mean", "obs_var", "obs_count", "v_mean",
        "v_var", "v_count", "values", "adv", "ret", "part", "stats",
        "consts", "obs_n", "actions", "neglogp", "mus", "adv_n", "ret_n")]
        + [(n, ctypes.c_int) for n in ("n", "horizon", "obs", "bootstrap")]
        + [(n, ctypes.c_float) for n in ("gamma", "gamma_tau",
                                         "reward_scale")])


PHASES = ("gae", "stats", "dataset")
KERNEL = build.CudaKernel(
    "epoch_prep",
    {f"epoch_prep_{p}_launch": [ctypes.POINTER(_PrepArgs), ctypes.c_void_p]
     for p in PHASES},
    extra_flags=["-fmad=false"])


def _check(rec, last_value, obs_rms, value_rms):
    if rec.dim() != 3 or rec.dtype != torch.float32 \
            or not rec.is_contiguous():
        raise ValueError(f"rec: want a contiguous float32 [H, K + 13, N] "
                         f"record, got {rec.dtype} {tuple(rec.shape)}")
    H, F, N = rec.shape
    K = F - 13
    if not 0 < K <= MAX_OBS or N % WARP:
        raise ValueError(f"rec [H, K + 13, N]: want 0 < K <= {MAX_OBS} and "
                         f"N a multiple of {WARP}, got {tuple(rec.shape)}")
    if tuple(last_value.shape) != (N,) or last_value.dtype != torch.float32:
        raise ValueError(f"last_value: want float32 ({N},), got "
                         f"{last_value.dtype} {tuple(last_value.shape)}")
    for name, rms, shape in (("obs_rms", obs_rms, (K,)),
                             ("value_rms", value_rms, ())):
        for f in RunningMeanStd._fields:
            x = getattr(rms, f)
            want = () if f == "count" else shape
            if tuple(x.shape) != want or x.dtype != torch.float64 \
                    or x.device != rec.device:
                raise ValueError(f"{name}.{f}: want float64 {want} on "
                                 f"{rec.device}")


def epoch_prep(rec, last_value, obs_rms: RunningMeanStd,
               value_rms: RunningMeanStd, *, gamma: float, tau: float,
               reward_scale: float, value_bootstrap: bool) -> Prep:
    """GAE, the running stats and the dataset of one epoch from the rollout
    kernel's record ``rec`` [H, K + 13, N] (read in place), the bootstrap
    value [N] (model space) and the pre-update running stats; the inputs
    are not modified."""
    kw = dict(gamma=gamma, tau=tau, reward_scale=reward_scale,
              value_bootstrap=value_bootstrap)
    if rec.is_cuda:
        return _kernel_prep(KERNEL, rec, last_value, obs_rms, value_rms, **kw)
    _check(rec, last_value, obs_rms, value_rms)
    return epoch_prep_plain(rec, last_value, obs_rms, value_rms, **kw)


def _kernel_prep(kernel, rec, last_value, obs_rms, value_rms, *, gamma, tau,
                 reward_scale, value_bootstrap) -> Prep:
    """The three launches of ``kernel`` on the current stream, their
    buffers on ``rec``'s device (a CPU build of the source takes CPU
    tensors and no stream)."""
    def launch(phase):
        kernel.call(f"epoch_prep_{phase}_launch", ctypes.byref(args), stream)
        kernel.launches[phase] += 1

    with profiling.span("gae"):
        _check(rec, last_value, obs_rms, value_rms)
        H, F, N = rec.shape
        K, B, dev = F - 13, N * H, rec.device
        stream = (torch.cuda.current_stream(dev).cuda_stream if rec.is_cuda
                  else None)
        f32 = torch.empty(3 * H * N + 2 * K + 4 + B * (K + 11),
                          dtype=torch.float32, device=dev)
        f64 = torch.empty(2 * K + 6 + (N // WARP) * (K + 3) * 3,
                          dtype=torch.float64, device=dev)
        values, adv, ret, consts, obs_n, actions, neglogp, mus, adv_n, \
            ret_n = torch.split(f32, [H * N] * 3 + [2 * K + 4, B * K, B * ACT,
                                                    B, B * ACT, B, B])
        stats, part = torch.split(f64, [2 * K + 6, f64.numel() - 2 * K - 6])
        last_value = last_value.contiguous()
        ptr = lambda x: x.data_ptr()
        args = _PrepArgs(
            *map(ptr, (rec, last_value, obs_rms.mean, obs_rms.var,
                       obs_rms.count, value_rms.mean, value_rms.var,
                       value_rms.count, values, adv, ret, part, stats, consts,
                       obs_n, actions, neglogp, mus, adv_n, ret_n)),
            N, H, K, int(bool(value_bootstrap)), gamma, gamma * tau,
            reward_scale)
        launch("gae")
    with profiling.span("stats"):
        launch("stats")
    with profiling.span("dataset"):
        launch("dataset")
        hn = lambda x: x.view(H, N)
        return Prep(
            hn(values), hn(adv), hn(ret),
            RunningMeanStd(stats[:K], stats[K:2 * K], stats[2 * K]),
            RunningMeanStd(stats[2 * K + 1], stats[2 * K + 2],
                           stats[2 * K + 3]),
            obs_n.view(B, K), actions.view(B, ACT), neglogp,
            mus.view(B, ACT), adv_n, ret_n)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The square root as the card rounds it, through float64: a float32
    root rounded from it is the correctly rounded one, as the card's
    sqrtf; the one float64 root (the advantages' std) is used rounded to
    float32, which an ulp of float64 does not move in practice."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def _chan(a, b):
    """(count, mean, M2) of a merged with b, as csrc/epoch_prep.cu chan."""
    n, mean, m2 = a
    nb, mb, m2b = b
    tot = n + nb
    d = mb - mean
    return (tot, mean + (d * nb) / tot,
            (m2 + m2b) + ((d * d) * (n * nb)) / tot)


def _rms_update(rms: RunningMeanStd, part) -> RunningMeanStd:
    """RunningMeanStd.update's float64 operations on a batch's (count,
    mean, M2), as csrc/epoch_prep.cu rms_update."""
    bc, bm, m2 = part
    bv = m2 / bc
    delta = bm - rms.mean
    tot = rms.count + bc
    m2 = ((rms.var * rms.count) + (bv * bc)) \
        + (((delta * delta) * rms.count) * bc) / tot
    return RunningMeanStd(rms.mean + (delta * bc) / tot, m2 / tot, tot)


def epoch_prep_plain(rec, last_value, obs_rms: RunningMeanStd,
                     value_rms: RunningMeanStd, *, gamma: float, tau: float,
                     reward_scale: float, value_bootstrap: bool) -> Prep:
    """Plain PyTorch version of ``csrc/epoch_prep.cu``: its three phases,
    each in the span of its name."""
    with profiling.span("gae"):
        values, adv, returns, part = plain_gae(
            rec, last_value, value_rms, gamma=gamma, tau=tau,
            reward_scale=reward_scale, value_bootstrap=value_bootstrap)
    with profiling.span("stats"):
        obs_rms, value_rms, consts = plain_stats(part, obs_rms, value_rms)
    with profiling.span("dataset"):
        return Prep(values, adv, returns, obs_rms, value_rms,
                    *plain_dataset(rec, adv, returns, consts))


def plain_gae(rec, last_value, value_rms: RunningMeanStd, *, gamma: float,
              tau: float, reward_scale: float, value_bootstrap: bool):
    """The ``gae`` kernel: values, advantages and returns [H, N], and the
    partial (count, mean, M2) [K + 3, N / 32, 1] of each block of 32 envs
    (the K observation features, the values, the returns, the
    advantages)."""
    H, F, N = rec.shape
    K, f32, f64 = F - 13, torch.float32, torch.float64
    # compute_gae's operations, with the pre-update value stats
    mv = value_rms.mean.to(f32)
    sd = _sqrt(value_rms.var.to(f32) + 1e-5)
    values = rec[:, K + 5] * sd + mv
    next_value = last_value * sd + mv
    rew = rec[:, K + 10] * reward_scale
    if value_bootstrap:
        rew = rew + gamma * values * (rec[:, K + 12] > 0.5).to(f32)
    nonterminal = 1.0 - (rec[:, K + 11] > 0.5).to(f32)
    adv = torch.empty_like(rew)
    lastgaelam = torch.zeros_like(next_value)
    for t in reversed(range(H)):
        nt = nonterminal[t]
        delta = rew[t] + gamma * next_value * nt - values[t]
        lastgaelam = delta + gamma * tau * nt * lastgaelam
        adv[t] = lastgaelam
        next_value = values[t]
    returns = adv + values

    # each env's (count, mean, M2) of the K + 3 quantities over the steps,
    # then the lanes' tree of each block of 32 envs
    x = torch.cat([rec[:, :K], torch.stack([values, returns, adv], 1)],
                  1).to(f64)                                # [H, Q, N]
    cnt = torch.full(x.shape[1:], float(H), dtype=f64, device=rec.device)
    s = torch.zeros_like(cnt)
    for t in range(H):
        s = s + x[t]
    mean = s / cnt
    m2 = torch.zeros_like(cnt)
    for t in range(H):
        e = x[t] - mean
        m2 = m2 + e * e
    part = [v.reshape(K + 3, N // WARP, WARP) for v in (cnt, mean, m2)]
    off = WARP // 2
    while off:
        part = _chan([v[..., :off] for v in part],
                     [v[..., off:2 * off] for v in part])
        off //= 2
    return values, adv, returns, part


def plain_stats(part, obs_rms: RunningMeanStd, value_rms: RunningMeanStd):
    """The ``stats`` kernel: the partials merged in block order into the
    new observation and value stats, and the float32 constants of the
    normalisations (obs mean, obs sd, return mean, return sd, advantage
    mean, advantage std + 1e-8)."""
    f32 = torch.float32
    K = part[0].shape[0] - 3
    acc = [v[:, 0, 0] for v in part]
    for b in range(1, part[0].shape[1]):
        acc = _chan(acc, [v[:, b, 0] for v in part])
    n, mean, m2 = acc
    o = _rms_update(obs_rms, (n[:K], mean[:K], m2[:K]))
    obs_rms = RunningMeanStd(o.mean, o.var, o.count[0])
    pick = lambda i: (n[i], mean[i], m2[i])
    value_rms = _rms_update(_rms_update(value_rms, pick(K)), pick(K + 1))
    consts = (obs_rms.mean.to(f32), _sqrt(obs_rms.var.to(f32) + 1e-5),
              value_rms.mean.to(f32), _sqrt(value_rms.var.to(f32) + 1e-5),
              mean[K + 2].to(f32), _sqrt(m2[K + 2] / n[K + 2]).to(f32) + 1e-8)
    return obs_rms, value_rms, consts


def plain_dataset(rec, adv, returns, consts):
    """The ``dataset`` kernel: the env-major rows (obs normalised and
    clamped, actions, neglogp, mu, normalised advantages and returns)."""
    H, F, N = rec.shape
    K, B = F - 13, N * H
    obs_m, obs_sd, ret_m, ret_sd, adv_mean, adv_den = consts
    rows = lambda v: v.permute(2, 0, 1).reshape(B, -1).contiguous()
    em = lambda v: v.transpose(0, 1).reshape(B).contiguous()
    obs_n = torch.clamp((rows(rec[:, :K]) - obs_m) / obs_sd, -5.0, 5.0)
    return (obs_n, rows(rec[:, K:K + ACT]), em(rec[:, K + 4]),
            rows(rec[:, K + 6:K + 6 + ACT]), (em(adv) - adv_mean) / adv_den,
            torch.clamp((em(returns) - ret_m) / ret_sd, -5.0, 5.0))
