"""The .pth bridge between the port and the JAX package, both ways, and
``from_jax``'s folding of the JAX running stats' compensation carries."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from airgym_tpu.models import actor_critic as jac
from airgym_tpu.rl import checkpoint as jckpt
from airgym_tpu.rl import ppo as jppo
from airgym_tpu.rl.running_stats import RunningMeanStd as JaxRMS
from airgym_tpu_torch.models.actor_critic import ActorCritic
from airgym_tpu_torch.rl import checkpoint as tckpt
from airgym_tpu_torch.rl.running_stats import RunningMeanStd

OBS = np.random.default_rng(0).normal(0, 2, (256, 18)).astype(np.float32)


def test_port_pth_loads_in_jax(tmp_path):
    g = torch.Generator().manual_seed(0)
    model = ActorCritic(18, 4, generator=g)
    with torch.no_grad():
        model.logstd.fill_(-0.4)
        model.mu.bias.normal_(generator=g)
    obs_rms = RunningMeanStd.create((18,)).update(
        torch.randn((1000, 18), generator=g, dtype=torch.float64) * 2 + 1)
    value_rms = RunningMeanStd.create(()).update(
        torch.randn(500, generator=g, dtype=torch.float64))
    ts = types.SimpleNamespace(model=model, obs_rms=obs_rms,
                               value_rms=value_rms, epoch=5, frame=777)
    path = str(tmp_path / "port.pth")
    tckpt.export_pth(path, ts, last_mean_rewards=12.5)

    jmodel = jac.ActorCritic(num_actions=4)
    tmpl = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 18)))
    params, orms, vrms, meta = jckpt.import_pth(
        path, tmpl, JaxRMS.create((18,)), JaxRMS.create(()))
    p = params["params"]
    for i in range(3):
        np.testing.assert_array_equal(
            p["actor_mlp"][f"Dense_{i}"]["kernel"],
            model.actor_mlp.layers[i].weight.detach().numpy().T)
    np.testing.assert_array_equal(p["logstd"], model.logstd.detach().numpy())
    for j, t in ((orms, obs_rms), (vrms, value_rms)):
        np.testing.assert_allclose(
            np.asarray(j.mean, np.float64) + np.asarray(j.mean_c),
            t.mean.numpy(), rtol=1e-12)
        np.testing.assert_allclose(
            np.asarray(j.count, np.float64) + np.asarray(j.count_c),
            t.count.numpy(), rtol=1e-12)
    assert (meta["epoch"], meta["frame"]) == (5, 777)
    mu_j, _, v_j = jmodel.apply(params, jnp.asarray(OBS), orms)
    with torch.no_grad():
        mu_t, _, v_t = model(torch.from_numpy(OBS), obs_rms)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), atol=1e-5)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-5)


def test_jax_pth_loads_in_port(tmp_path):
    jmodel = jac.ActorCritic(num_actions=4)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 18)))
    params = jax.tree.map(lambda x: x + 0.05, params)   # nonzero heads
    orms = JaxRMS.create((18,)).update(jnp.asarray(OBS * 1.5 + 0.3))
    vrms = JaxRMS.create(()).update(jnp.asarray(OBS[:, 0]))
    ts = types.SimpleNamespace(params=params, obs_rms=orms, value_rms=vrms,
                               epoch=3, frame=jppo.frame_from_int(12345))
    path = str(tmp_path / "jax.pth")
    jckpt.export_pth(path, ts)

    model = ActorCritic(18, 4)
    obs_rms, value_rms, meta = tckpt.import_pth(
        path, model, RunningMeanStd.create((18,)), RunningMeanStd.create(()))
    assert (meta["epoch"], meta["frame"]) == (3, 12345)
    assert obs_rms.mean.dtype == torch.float64 and value_rms.mean.shape == ()
    mu_j, sigma_j, v_j = jmodel.apply(params, jnp.asarray(OBS), orms)
    with torch.no_grad():
        mu_t, sigma_t, v_t = model(torch.from_numpy(OBS), obs_rms)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), atol=1e-5)
    np.testing.assert_allclose(sigma_t.numpy(), np.asarray(sigma_j),
                               atol=1e-6)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-5)


def test_from_jax_folds_carries_into_float64():
    rms = JaxRMS(mean=np.full(18, 1.0, np.float32),
                 var=np.full(18, 2.0, np.float32),
                 count=np.float32(3e8),
                 mean_c=np.full(18, 1e-9, np.float32),
                 var_c=np.full(18, -2e-9, np.float32),
                 count_c=np.float32(5.0))
    ck = tckpt.from_jax({"params": {
        "actor_mlp": {f"Dense_{i}": {"kernel": np.zeros((a, b), np.float32),
                                     "bias": np.zeros(b, np.float32)}
                      for i, (a, b) in enumerate([(18, 64), (64, 128),
                                                  (128, 64)])},
        "mu": {"kernel": np.zeros((64, 4), np.float32),
               "bias": np.zeros(4, np.float32)},
        "value": {"kernel": np.zeros((64, 1), np.float32),
                  "bias": np.zeros(1, np.float32)},
        "logstd": np.zeros(4, np.float32)}}, rms, None, lr=1e-3)
    o = ck["obs_rms"]
    assert o["mean"].dtype == torch.float64
    np.testing.assert_array_equal(o["mean"].numpy(),
                                  1.0 + np.float64(np.float32(1e-9)))
    np.testing.assert_array_equal(o["var"].numpy(),
                                  2.0 + np.float64(np.float32(-2e-9)))
    assert float(o["count"]) == float(np.float32(3e8)) + 5.0
    assert ck["value_rms"] is None and ck["lr"] == 1e-3
    assert ck["model"]["actor_mlp.layers.1.weight"].shape == (128, 64)
