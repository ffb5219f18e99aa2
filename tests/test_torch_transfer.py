"""The robot-count curriculum's warm start in the port
(rl/checkpoint.transfer_obs_width and the runner's transfer_checkpoint
branch): R2 -> R4 -> R2 with the outputs bitwise equal on the CPU (as
tests/test_ma_depthgen_vae.py::test_transfer_obs_width_exact holds the
JAX package's), the port's result against the JAX function's on one
source state carried by ``checkpoint.from_jax`` (parameters bitwise,
stats to rtol 1e-12 of the float64 fold of JAX's carries), a separate
trunk on vector observations, the image-shape guard, and a CLI run of
the branch."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import airgym_tpu.envs as jenvs
from airgym_tpu.rl import checkpoint as jckpt
from airgym_tpu.rl import ppo as jppo
import airgym_tpu_torch.envs as tenvs
from airgym_tpu_torch import cli
from airgym_tpu_torch.models import actor_critic as tac
from airgym_tpu_torch.rl import checkpoint as tckpt
from airgym_tpu_torch.rl import ppo as tppo
from airgym_tpu_torch.rl.running_stats import RunningMeanStd
from test_torch_ppo import jax_named

KW = dict(obs_noise=False, cam_width=24, cam_height=20)
NKW = {"image_encoder": "cnn", "image_feature_dim": 8,
       "cnn_compute_dtype": None}
CFG = dict(horizon=4, minibatch_size=8)
host = lambda tree: jax.tree.map(np.asarray, tree)


def port_trainer(r):
    return tppo.PPO(tenvs.make_task("maplanning", num_envs=2, num_robots=r,
                                    device="cpu", **KW),
                    tppo.PPOConfig(**CFG), network_kw=NKW)


def matched_obs(r, seed=4):
    """The same 3 observations at R robots: 16 channels and R * 2 zeros."""
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.uniform(0, 1, (3, 1, 24, 20)).astype(
        np.float32))
    vec = torch.from_numpy(rng.normal(0, 1, (3, 16)).astype(np.float32))
    return {"image": img,
            "observation": torch.cat([vec, torch.zeros(3, 2 * r)], -1)}


def source_state(tr2):
    """An R2 state with non-trivial stats, the zeroed robot channels kept
    at their training-time value (always exactly 0)."""
    ts = tr2.init(0)
    g = torch.Generator().manual_seed(3)
    batch = torch.randn(64, 16 + 4 + 8, generator=g)
    batch[:, 16:20] = 0.0
    img = torch.rand((5, 1, 24, 20), generator=g)
    return dataclasses.replace(ts, obs_rms={
        "image": ts.obs_rms["image"].update(img),
        "observation": ts.obs_rms["observation"].update(batch)},
        lr=torch.tensor(7e-4), epoch=5, frame=640)


def outputs(ts, obs):
    with torch.no_grad():
        return ts.model(obs, ts.obs_rms)


def test_transfer_r2_r4_r2_is_bitwise_exact():
    tr2, tr4 = port_trainer(2), port_trainer(4)
    ts2 = source_state(tr2)
    ts4 = tckpt.transfer_obs_width(tr4, tr4.init(1), tckpt.payload(ts2),
                                   16 + 4, 16 + 8)
    for a, b in zip(outputs(ts2, matched_obs(2)),
                    outputs(ts4, matched_obs(4))):
        assert torch.equal(a, b)
    assert ts4.epoch == 0 and ts4.frame == 0
    assert float(ts4.lr) == pytest.approx(7e-4)
    assert float(ts4.adam["count"][0]) == 0.0 and all(
        not m.any() for m in ts4.adam["m"].values())
    w = ts4.model.actor_mlp.layers[0].weight
    assert w.shape[1] == 16 + 8 + 8 and not w[:, 20:24].any()
    assert torch.equal(ts4.obs_rms["observation"].var[20:24],
                       torch.ones(4, dtype=torch.float64))
    assert ts4.obs_rms["observation"].count == ts2.obs_rms[
        "observation"].count
    # slice back R4 -> R2: the source's outputs exactly
    ts2b = tckpt.transfer_obs_width(tr2, tr2.init(6), tckpt.payload(ts4),
                                    16 + 8, 16 + 4)
    for a, b in zip(outputs(ts2, matched_obs(2)),
                    outputs(ts2b, matched_obs(2))):
        assert torch.equal(a, b)


def test_transfer_matches_jax():
    """One JAX source state, carried into the port by from_jax: both
    transfers give the same parameters and stats."""
    jcfg = jppo.PPOConfig(**CFG)
    jnkw = {"image_encoder": "cnn", "image_feature_dim": 8,
            "cnn_compute_dtype": None}
    jtr2 = jppo.PPO(jenvs.make_task("maplanning", num_envs=2, num_robots=2,
                                    **KW), jcfg, network_kw=jnkw)
    jtr4 = jppo.PPO(jenvs.make_task("maplanning", num_envs=2, num_robots=4,
                                    **KW), jcfg, network_kw=jnkw)
    js2 = jtr2.init(jax.random.PRNGKey(0))
    k = jax.random.PRNGKey(3)
    batch = jax.random.normal(k, (64, 28)).at[:, 16:20].set(0.0)
    js2 = js2._replace(obs_rms={
        "image": js2.obs_rms["image"].update(
            jax.random.uniform(k, (5, 1, 24, 20))),
        "observation": js2.obs_rms["observation"].update(batch)},
        lr=jnp.asarray(7e-4, jnp.float32))
    js4 = jckpt.transfer_obs_width(jtr4, jtr4.init(jax.random.PRNGKey(1)),
                                   js2, 20, 24)

    tr2, tr4 = port_trainer(2), port_trainer(4)
    ck = tckpt.from_jax(host(js2.params), host(js2.obs_rms),
                        host(js2.value_rms), lr=float(js2.lr))
    ts2 = tckpt.restore(tr2.init(0), ck)
    ts4 = tckpt.transfer_obs_width(tr4, tr4.init(1), tckpt.payload(ts2),
                                   20, 24)
    got = ts4.model.state_dict()
    for name, ref in jax_named(js4.params).items():
        np.testing.assert_array_equal(got[name].numpy(), ref, err_msg=name)
    want = tckpt.from_jax(host(js4.params), host(js4.obs_rms),
                          host(js4.value_rms))
    for key in ("image", "observation"):
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(
                getattr(ts4.obs_rms[key], f).numpy(),
                want["obs_rms"][key][f].numpy(), rtol=1e-12,
                err_msg=f"{key}.{f}")
    np.testing.assert_allclose(float(ts4.lr), float(js4.lr), rtol=1e-7)
    assert int(js4.opt_state[0].count) == int(ts4.adam["count"][0]) == 0


def test_transfer_separate_trunk_on_vector_obs():
    """With ``separate`` both trunks' first layers are re-indexed, and
    vector-obs stats are re-indexed as the 'observation' stats are."""
    tr = tppo.PPO(tenvs.make_task("hovering", num_envs=4, device="cpu"),
                  tppo.PPOConfig(**CFG), network_kw={"separate": True})
    g = torch.Generator().manual_seed(0)
    src = tac.ActorCritic(14, 4, separate=True, generator=g)
    stats = torch.randn(32, 14, generator=g)
    ts_src = dataclasses.replace(
        tr.init(0), model=src,
        obs_rms=RunningMeanStd.create((14,)).update(stats))
    ts = tckpt.transfer_obs_width(tr, tr.init(1), tckpt.payload(ts_src), 14,
                                  18)
    assert ts.model.critic_mlp.layers[0].weight.shape[1] == 18
    x = torch.randn(5, 14, generator=g)
    x18 = torch.cat([x, torch.zeros(5, 4)], -1)
    for a, b in zip(outputs(ts_src, x), outputs(ts, x18)):
        assert torch.equal(a, b)


def test_transfer_refuses_another_camera():
    tr2 = port_trainer(2)
    tr4 = tppo.PPO(tenvs.make_task("maplanning", num_envs=2, num_robots=4,
                                   device="cpu", obs_noise=False,
                                   cam_width=32, cam_height=20),
                   tppo.PPOConfig(**CFG), network_kw=NKW)
    with pytest.raises(ValueError, match="image stats"):
        tckpt.transfer_obs_width(tr4, tr4.init(0),
                                 tckpt.payload(tr2.init(0)), 20, 24)


def test_cli_runs_the_transfer_branch(tmp_path, monkeypatch):
    """MAPlanning trains one epoch at 2 robots, then --transfer_checkpoint
    warm-starts 4 robots from its native .pt and trains one epoch."""
    monkeypatch.chdir(tmp_path)
    with open(cli.CONFIG_DIR + "/ppo_maplanning.yaml") as f:
        cfg = yaml.safe_load(f)
    c = cfg["params"]["config"]
    c.update(max_epochs=1, horizon_length=4, minibatch_size=16,
             mini_epochs=1, save_best_after=1)
    cfg["params"]["network"]["cnn"]["output_dim"] = 8
    paths = {}
    for r in (2, 4):
        c["env_config"] = {"use_image": True, "num_robots": r, **KW}
        paths[r] = str(tmp_path / f"r{r}.yaml")
        with open(paths[r], "w") as f:
            yaml.safe_dump(cfg, f)
    base = ["--train", "--task", "maplanning", "--num_envs", "2",
            "--device", "cpu", "--seed", "1"]
    ts2, info2 = cli.run_cli(base + ["--file", paths[2]])
    ts4, info4 = cli.run_cli(base + [
        "--file", paths[4], "--transfer_checkpoint", info2["checkpoint"],
        "--transfer_old_obs_dim", "20"])
    assert info4["epochs"] == 1 and ts4.epoch == 1
    assert math.isfinite(info4["history"][-1]["mean_reward"])
    w = ts4.model.actor_mlp.layers[0].weight
    assert w.shape[1] == 24 + 8
    assert float(ts4.adam["count"][0]) == ts4.epoch * (
        2 * 4 * 4 // 16) * 1
