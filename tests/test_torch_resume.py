"""The port's runner resumes from a reference .pth written by the JAX
package's ``export_pth``: parameters and running stats as in the file
(float32 parameters bit for bit, float64 stats to rtol 1e-12), epoch and
frame from its meta, Adam and lr as ``init`` made them; then one more
epoch trains with finite metrics."""
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml

import airgym_tpu.envs as jenvs
from airgym_tpu.rl import checkpoint as jckpt
from airgym_tpu.rl import ppo as jppo
from airgym_tpu.rl.fused_ppo import FusedHoveringPPO as JaxFusedPPO
from airgym_tpu_torch.rl import checkpoint as tckpt
from airgym_tpu_torch.rl.fused_ppo import FusedHoveringPPO
from airgym_tpu_torch.rl.runner import Runner

N = 1024
REPO = pathlib.Path(__file__).resolve().parents[1]


def _jax_pth(path):
    """A JAX Hovering TrainState with moved parameters and stats, at epoch
    3 and frame 12345, exported as .pth."""
    jtr = JaxFusedPPO(jenvs.make_task("hovering", ctl_mode="rate",
                                      num_envs=N),
                      jppo.PPOConfig(horizon=4, minibatch_size=1024,
                                     mini_epochs=2))
    ts = jtr.init(jax.random.PRNGKey(4))
    rng = np.random.default_rng(4)
    params = jax.tree.map(
        lambda x: x + jnp.asarray(rng.normal(0, 0.05, x.shape), x.dtype),
        ts.params)
    obs = rng.normal(0.5, 2.0, (4096, 18)).astype(np.float32)
    ts = ts._replace(
        params=params,
        obs_rms=ts.obs_rms.update(jnp.asarray(obs)),
        value_rms=ts.value_rms.update(jnp.asarray(obs[:, 3] * 7.0)),
        epoch=jnp.asarray(3, jnp.int32), frame=jppo.frame_from_int(12345))
    jckpt.export_pth(str(path), ts)
    return ts


def _full(rms, name):
    c = getattr(rms, name + "_c", None)
    v = np.asarray(getattr(rms, name), np.float64)
    return v if c is None else v + np.asarray(c, np.float64)


def test_runner_resumes_from_jax_pth(tmp_path, monkeypatch):
    path = tmp_path / "jax_hovering.pth"
    ts_j = _jax_pth(path)

    with open(REPO / "airgym_tpu_torch" / "configs" / "ppo_hovering.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["params"]["config"].update(num_actors=N, horizon_length=4,
                                   minibatch_size=1024, mini_epochs=2,
                                   max_epochs=4, save_best_after=100)
    seen = []
    train_epoch = FusedHoveringPPO.train_epoch

    def spy(self, ts, *a, **kw):
        if not seen:
            seen.append(dict(
                model={k: v.clone() for k, v in ts.model.state_dict().items()},
                obs_rms=ts.obs_rms, value_rms=ts.value_rms, lr=float(ts.lr),
                count=float(ts.adam["count"][0]),
                m_zero=all(not v.any() for v in ts.adam["m"].values()),
                epoch=ts.epoch, frame=ts.frame))
        return train_epoch(self, ts, *a, **kw)

    monkeypatch.setattr(FusedHoveringPPO, "train_epoch", spy)
    monkeypatch.chdir(tmp_path)
    ts, info = Runner().load(cfg).run({
        "train": True, "task": "hovering", "ctl_mode": "rate",
        "device": "cpu", "seed": 2, "checkpoint": str(path)})

    got = seen[0]
    host = jax.tree.map(np.asarray, ts_j.params)
    for k, v in tckpt._jax_params_to_ref(host).items():
        assert torch.equal(got["model"][k], v), k
    for rms_t, rms_j in ((got["obs_rms"], ts_j.obs_rms),
                         (got["value_rms"], ts_j.value_rms)):
        for name in ("mean", "var", "count"):
            np.testing.assert_allclose(
                getattr(rms_t, name).numpy(), _full(rms_j, name),
                rtol=1e-12, err_msg=name)
    assert (got["epoch"], got["frame"]) == (3, 12345)
    # the .pth holds no optimizer state: Adam and lr as init made them
    assert got["count"] == 0.0 and got["m_zero"]
    assert got["lr"] == np.float32(cfg["params"]["config"]["learning_rate"])

    assert [r["epoch"] for r in info["history"]] == [4]
    assert ts.epoch == 4 and ts.frame == 12345 + N * 4
    for k in ("mean_reward", "loss", "kl", "lr"):
        assert math.isfinite(info["history"][0][k]), k
