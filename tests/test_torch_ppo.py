"""The port's plain PPO trainer (rl/ppo.py) on vector observations vs the
JAX one: one update on the same dataset with each switchable loss /
schedule option, the advantage moving stats, and the vector-obs tasks
training with it at an env count the fused kernels cannot tile.

The dataset is made with numpy and handed to both sides; the JAX state is
carried into the port with ``checkpoint.from_jax``. Params and Adam
moments within 2e-3 * max|ref| + 1e-5 per tensor, lr to rtol 1e-6,
metrics to rtol 5e-3 / atol 5e-4 (the tolerances of
tests/test_fused_update.py)."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import airgym_tpu.envs as jenvs
import airgym_tpu_torch.envs as tenvs
from airgym_tpu.rl import moving_stats as jms
from airgym_tpu.rl import ppo as jppo
from airgym_tpu_torch.rl import checkpoint as tckpt
from airgym_tpu_torch.rl import losses as tlosses
from airgym_tpu_torch.rl import moving_stats as tms
from airgym_tpu_torch.rl import ppo as tppo
from airgym_tpu_torch.rl.fused_ppo import FusedHoveringPPO

N, H = 64, 8
SMALL = dict(horizon=H, minibatch_size=128, mini_epochs=3)


def close_tensors(ref: dict, got: dict):
    for k, a in ref.items():
        a = np.asarray(a)
        b = got[k].detach().numpy().reshape(a.shape)
        scale = max(np.abs(a).max(), 1e-3)
        assert np.abs(a - b).max() < 2e-3 * scale + 1e-5, k


def jax_named(params) -> dict:
    """flax params -> reference names (as from_jax maps them)."""
    host = jax.tree.map(np.asarray, params)
    return {k: v.numpy() for k, v in tckpt._jax_params_to_ref(host).items()}


def pair(cfg_kw, task="hovering", n=N, trainer=tppo.PPO):
    cfg_j = jppo.PPOConfig(**{**SMALL, **cfg_kw})
    cfg_t = tppo.PPOConfig(**{**SMALL, **cfg_kw})
    jt = jppo.PPO(jenvs.make_task(task, num_envs=n), cfg_j)
    tt = trainer(tenvs.make_task(task, num_envs=n, device="cpu"), cfg_t)
    ts_j = jt.init(jax.random.PRNGKey(0))
    host = lambda tree: jax.tree.map(np.asarray, tree)
    ck = tckpt.from_jax(host(ts_j.params), host(ts_j.obs_rms),
                        host(ts_j.value_rms),
                        adam_np=host(ts_j.opt_state[0]), lr=float(ts_j.lr))
    ts_t = tckpt.restore(tt.init(0), ck)
    return jt, tt, ts_j, ts_t


def dataset(obs_dim, seed=0, B=N * H):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    mus = 0.3 * f(B, 4)
    actions = mus + f(B, 4)
    nlp = (0.5 * np.sum((actions - mus) ** 2, -1)
           + 0.5 * np.log(2 * np.pi) * 4).astype(np.float32)
    return {"obs": 2.0 * f(B, obs_dim), "actions": actions,
            "neglogp": nlp + 0.05 * f(B), "values": f(B), "returns": f(B),
            "adv": f(B), "mus_init": mus,
            "sigmas_init": np.ones((B, 4), np.float32)}


def to_torch(d):
    return {k: (to_torch(v) if isinstance(v, dict) else torch.from_numpy(v))
            for k, v in d.items()}


def to_jax(d):
    return {k: (to_jax(v) if isinstance(v, dict) else jnp.asarray(v))
            for k, v in d.items()}


@pytest.mark.parametrize("option", ["default", "clip_value", "smooth_clamp",
                                    "linear", "fixed", "fused_linear"])
def test_update_matches_jax(option):
    """One update phase (3 mini-epochs x 4 minibatches) on the same
    dataset; each option switches one config of the non-fused trainer.
    ``fused_linear``: the fused trainer's update (the update kernel's
    plain version) under the linear schedule, at one 1024-env tile."""
    linear = dict(lr_schedule="linear", max_epochs=10)
    kw = {"clip_value": dict(clip_value=True),
          "smooth_clamp": dict(use_smooth_clamp=True),
          "linear": linear,
          "fused_linear": dict(linear, minibatch_size=2048),
          "fixed": dict(lr_schedule="fixed")}.get(option, {})
    n, trainer = ((1024, FusedHoveringPPO) if option == "fused_linear"
                  else (N, tppo.PPO))
    jt, tt, ts_j, ts_t = pair(kw, n=n, trainer=trainer)
    if option.endswith("linear"):
        ts_j = ts_j._replace(epoch=jnp.asarray(4, jnp.int32))
        ts_t = dataclasses.replace(ts_t, epoch=4)
    d = dataset(18, seed=1, B=n * H)
    ts_j2, m_j = jax.jit(jt.update)(ts_j, to_jax(d))
    d_t = to_torch(d)
    if option == "fused_linear":
        assert tt.update_kernel
        # the update kernel takes the observations normalised (_dataset)
        d_t["obs"] = ts_t.obs_rms.normalize(d_t["obs"])
    ts_t2, m_t = tt.update(ts_t, d_t)
    close_tensors(jax_named(ts_j2.params),
                  dict(ts_t2.model.named_parameters()))
    adam = ts_j2.opt_state[0]
    close_tensors(jax_named(adam.mu), ts_t2.adam["m"])
    close_tensors(jax_named(adam.nu), ts_t2.adam["v"])
    assert float(ts_t2.adam["count"][0]) == int(adam.count) == 3 * 4
    np.testing.assert_allclose(float(ts_t2.lr), float(ts_j2.lr), rtol=1e-6)
    if option.endswith("linear"):
        np.testing.assert_allclose(float(ts_t2.lr), 3e-4 * 0.6, rtol=1e-6)
    for k in tppo.METRICS:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=5e-3,
                                   atol=5e-4, err_msg=k)


def test_loss_fn_matches_jax():
    jt, tt, ts_j, ts_t = pair(dict(clip_value=True))
    d = dataset(18, seed=2, B=256)
    d["mus"], d["sigmas"] = d["mus_init"], 1.1 * d["sigmas_init"]
    loss_j, aux_j = jt._loss_fn(ts_j.params, ts_j.obs_rms, ts_j.value_rms,
                                to_jax(d))
    loss_t, aux_t = tt._loss_fn(ts_t.model, ts_t.obs_rms, ts_t.value_rms,
                                to_torch(d))
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5,
                               atol=1e-6)
    for k in ("a_loss", "c_loss", "b_loss", "entropy", "kl", "clip_frac"):
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(aux_t["mu"].numpy(), np.asarray(aux_j["mu"]),
                               atol=1e-5)


def test_smooth_clamp_and_moving_stats_match_jax():
    from airgym_tpu.rl import losses as jlosses
    x = np.linspace(0.0, 2.0, 101).astype(np.float32)
    np.testing.assert_allclose(
        tlosses.smooth_clamp(torch.from_numpy(x), 0.8, 1.2).numpy(),
        np.asarray(jlosses.smooth_clamp(jnp.asarray(x), 0.8, 1.2)),
        rtol=1e-6, atol=1e-7)
    rng = np.random.default_rng(3)
    ms_j, ms_t = jms.MovingStats.create(()), tms.MovingStats.create(())
    for i in range(3):
        a = (rng.normal(size=(8, 32)) * (i + 1) + i).astype(np.float32)
        ms_j = jms.update_mean_std(ms_j, jnp.asarray(a), decay=0.995)
        ms_t = tms.update_mean_std(ms_t, torch.from_numpy(a), decay=0.995)
        np.testing.assert_allclose(float(ms_t.center), float(ms_j.center),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(float(ms_t.scale), float(ms_j.scale),
                                   rtol=1e-6)
        np.testing.assert_allclose(
            tms.normalize(ms_t, torch.from_numpy(a)).numpy(),
            np.asarray(jms.normalize(ms_j, jnp.asarray(a))), rtol=1e-5,
            atol=1e-6)


def test_rms_advantage_train_epoch_runs():
    """normalize_rms_advantage: the epoch's advantages go through the
    moving stats, which the checkpoint carries."""
    task = tenvs.make_task("hovering", num_envs=N, device="cpu")
    tr = tppo.PPO(task, tppo.PPOConfig(**SMALL, normalize_rms_advantage=True))
    ts = tr.init(0)
    ts2, m = tr.train_epoch(ts)
    assert float(ts2.adv_ms.initialized) == 1.0
    assert math.isfinite(float(m["loss"]))
    back = tckpt.restore(tr.init(1), tckpt.payload(ts2))
    assert torch.equal(back.adv_ms.center, ts2.adv_ms.center)


@pytest.mark.parametrize("name", ["hovering", "balloon", "tracking"])
def test_plain_trainer_trains_vector_tasks(name):
    """The plain rollout + update on the vector-obs tasks at an env count
    the fused kernels cannot tile."""
    task = tenvs.make_task(name, num_envs=N, device="cpu")
    tr = tppo.PPO(task, tppo.PPOConfig(**SMALL))
    ts = tr.init(3)
    for _ in range(2):
        ts, m = tr.train_epoch(ts)
    assert ts.epoch == 2 and ts.frame == 2 * N * H
    for k in ("loss", "kl", "mean_reward", "explained_variance", "lr"):
        assert math.isfinite(float(m[k])), k
    assert float(ts.adam["count"][0]) == 2 * 3 * 4
    assert ("success_rate" in m) == (name == "balloon")
    assert any(k.startswith("Episode/") for k in m)
