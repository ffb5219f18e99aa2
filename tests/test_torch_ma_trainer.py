"""The port's PPO on the multi-agent and the Avoid tasks vs the JAX
package: one MAPlanning train epoch end to end, the env-level success
tracker, the checkpoint's success trackers, and CPU CLI runs of
MAPlanning and Avoid.

The epoch: a JAX TrainState is carried into the port with
``checkpoint.from_jax`` together with its env state, and both sides
take the policy mean as the action (the Gaussian draws come from
different generators), so the rollouts see the same states. The JAX side
renders with the port's plain raw depth version (a host callback), so
that the epoch compares the trainers alone (the renderers are held to
each other in tests/test_torch_render_depth.py and
tests/test_torch_maplanning.py); the CNN runs in float32 on both sides. Params and moments within 2e-3 * max|ref| +
1e-5 per tensor, lr to rtol 1e-6, metrics to rtol 5e-3 / atol 5e-4 (the
tolerances of tests/test_torch_vision_ppo.py)."""
import dataclasses
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import airgym_tpu.envs as jenvs
import airgym_tpu_torch.envs as tenvs
from airgym_tpu.models import actor_critic as jac
from airgym_tpu.render import depth as jdr
from airgym_tpu.rl import ppo as jppo
from airgym_tpu.rl.running_stats import RunningMeanStd as JaxRMS
from airgym_tpu_torch import cli
from airgym_tpu_torch.models import actor_critic as tac
from airgym_tpu_torch.physics import scene as tsc
from airgym_tpu_torch.render import depth as tdr
from airgym_tpu_torch.render import raycast as trc
from airgym_tpu_torch.rl import checkpoint as tckpt
from airgym_tpu_torch.rl import ppo as tppo
from airgym_tpu_torch.rl.runner import Runner
from test_torch_maplanning import to_port_state
from test_torch_ppo import close_tensors, jax_named

E, R, H = 2, 4, 4
CAM = dict(cam_width=32, cam_height=16)
SMALL = dict(horizon=H, minibatch_size=16, mini_epochs=2)
NET = dict(image_encoder="cnn", cnn_compute_dtype=None)
REPO = pathlib.Path(__file__).resolve().parents[1]
host = lambda tree: jax.tree.map(np.asarray, tree)


def port_render_depth(cfg, root, scene, cull_far_z=None):
    """The JAX MAPlanning scene (spheres and the ground) rendered by the
    port's plain raw depth version, through a host callback: both
    trainers then see the same images."""
    cam = tdr.CameraCfg(width=cfg.width, height=cfg.height)
    s = scene.spheres

    def cb(root, center, radius, valid):
        t = lambda a: torch.from_numpy(np.array(a))
        sph = tsc.Spheres(center=t(center), radius=t(radius), valid=t(valid))
        return trc.render_depth_plain(cam, t(root), tdr.SceneForRender(
            spheres=sph, ground=scene.ground)).numpy()

    out = jax.ShapeDtypeStruct((root.shape[0], cfg.width, cfg.height),
                               jnp.float32)
    return jax.pure_callback(cb, out, root, s.center, s.radius, s.valid)


def test_maplanning_train_epoch_from_jax_matches_jax(monkeypatch):
    monkeypatch.setattr(jdr, "render_depth_auto", port_render_depth)
    jtr = jppo.PPO(jenvs.make_task("maplanning", num_envs=E, **CAM),
                   jppo.PPOConfig(**SMALL), network_kw=NET)
    ttr = tppo.PPO(tenvs.make_task("maplanning", num_envs=E, device="cpu",
                                   **CAM), tppo.PPOConfig(**SMALL),
                   network_kw=NET)
    assert jtr.num_envs == ttr.num_envs == E * R
    assert ttr.batch_size == E * R * H and ttr.frame_dedup

    def j_mean_policy(params, obs_rms, obs, key):
        mu, sigma, value, prenorm = jtr.model.apply(params, obs, obs_rms,
                                                    return_prenorm=True)
        return (mu, jac.neglogp(mu, mu, sigma, jnp.log(sigma)), mu, sigma,
                value[..., 0], prenorm)

    def t_mean_policy(ts, obs, generator):
        mu, sigma, value, prenorm = ts.model(obs, ttr._rms(ts),
                                             return_prenorm=True)
        return (mu, tac.neglogp(mu, mu, sigma, torch.log(sigma)), mu, sigma,
                value[..., 0], prenorm)

    monkeypatch.setattr(jtr, "_policy", j_mean_policy)
    monkeypatch.setattr(ttr, "_policy", t_mean_policy)

    ts_j = jtr.init(jax.random.PRNGKey(0))
    # per-pixel image stats of 64 random frames: after a few frames of a
    # constant sky pixel, its normalised value (1 - mean) / sqrt(var +
    # 1e-5) cancels down to the float32 rounding of the mean, which the
    # two frameworks round differently
    stat_img = np.random.default_rng(7).uniform(
        0.0, 1.0, (64, 1, 32, 16)).astype(np.float32)
    ts_j = ts_j._replace(obs_rms={
        **ts_j.obs_rms,
        "image": JaxRMS.create((1, 32, 16)).update(jnp.asarray(stat_img))})
    ck = tckpt.from_jax(host(ts_j.params), host(ts_j.obs_rms),
                        host(ts_j.value_rms), adam_np=host(ts_j.opt_state[0]),
                        lr=float(ts_j.lr),
                        last_ep_success=host(ts_j.last_ep_success),
                        last_ep_env_success=host(ts_j.last_ep_env_success))
    env = to_port_state(ts_j.env_state)
    ts_t = dataclasses.replace(
        tckpt.restore(ttr.init(0), ck), env_state=env,
        obs={"image": env.camera, "observation": torch.from_numpy(
            np.array(ts_j.obs["observation"]))})

    ts_j2, m_j = jax.jit(jtr.train_epoch)(ts_j)
    ts_t2, m_t = ttr.train_epoch(ts_t)

    params_t = dict(ts_t2.model.named_parameters())
    ref = jax_named(ts_j2.params)
    close_tensors({k: v for k, v in ref.items() if k in params_t}, params_t)
    adam = ts_j2.opt_state[0]
    close_tensors({k: v for k, v in jax_named(adam.mu).items()
                   if k in ts_t2.adam["m"]}, ts_t2.adam["m"])
    assert float(ts_t2.adam["count"][0]) == int(adam.count) == 2 * 2
    np.testing.assert_allclose(float(ts_t2.lr), float(ts_j2.lr), rtol=1e-6)
    for k in tppo.METRICS + ("mean_reward", "reward_raw_per_step",
                             "explained_variance", "success_rate",
                             "env_success_rate"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=5e-3,
                                   atol=5e-4, err_msg=k)
    np.testing.assert_allclose(ts_t2.env_state.core.root.numpy(),
                               np.asarray(ts_j2.env_state.core.root),
                               atol=1e-4)
    np.testing.assert_allclose(ts_t2.obs_rms["image"].mean.numpy(),
                               np.asarray(ts_j2.obs_rms["image"].mean,
                                          np.float64)
                               + np.asarray(ts_j2.obs_rms["image"].mean_c),
                               rtol=1e-4, atol=1e-5)
    assert ts_t2.last_ep_env_success.shape == (E * R,)


def test_env_success_is_tracked_per_env_episode():
    """As tests/test_ma_depthgen_vae.py: the trainer's env-level tracker
    exists for MAPlanning only, env_success / env_done are consumed (not
    logged as Episode/ means), and an env whose robot reaches the goal
    records 1.0 on each of its robots' rows at the env's reset."""
    task = tenvs.make_task("maplanning", num_envs=E, device="cpu", **CAM)
    tr = tppo.PPO(task, tppo.PPOConfig(**SMALL),
                  network_kw={"image_feature_dim": 8})
    ts = tr.init(0)
    assert ts.last_ep_env_success.shape == (E * R,)
    assert float(ts.last_ep_env_success.abs().max()) == 0.0
    # robot 1 of env 1 sits on its goal: the first rollout step ends env
    # 1's episode in success
    st = ts.env_state
    root = st.core.root.clone()
    root[R + 1, 0:3] = st.goal[1] - torch.tensor([0.1, 0.0, 0.0])
    ts = dataclasses.replace(ts, env_state=st._replace(
        core=st.core._replace(root=root)))
    ts2, _, _, infos = tr.rollout(ts)
    assert "Episode/env_success" not in infos and "env_success" not in infos
    assert "env_done" not in infos and "success" not in infos
    got = ts2.last_ep_env_success.reshape(E, R)
    assert got[1].tolist() == [1.0] * R and float(got[0].abs().max()) == 0.0
    assert ts2.last_ep_success.reshape(E, R)[1].tolist() == [0, 1, 0, 0]
    ts3, m = tr.train_epoch(ts)
    assert float(m["env_success_rate"]) == 0.5
    assert float(m["success_rate"]) == 1.0 / (E * R)
    # tasks without the flag carry no tracker and no metric
    planning = tppo.PPO(tenvs.make_task("planning", num_envs=2, device="cpu",
                                        **CAM),
                        tppo.PPOConfig(horizon=H, minibatch_size=8,
                                       mini_epochs=1))
    ts_p, m_p = planning.train_epoch(planning.init(0))
    assert ts_p.last_ep_env_success is None and "env_success_rate" not in m_p


def test_checkpoint_round_trip_with_success_trackers(tmp_path):
    task = tenvs.make_task("maplanning", num_envs=E, device="cpu", **CAM)
    tr = tppo.PPO(task, tppo.PPOConfig(**SMALL),
                  network_kw={"image_feature_dim": 8})
    ts = tr.init(0)
    ts = dataclasses.replace(
        ts, last_ep_env_success=torch.tensor([1.0, 0.0] * R),
        last_ep_success=torch.tensor([0.0, 1.0] * R))
    path = str(tmp_path / "ma.pt")
    tckpt.save(path, ts)
    back = tckpt.restore(tr.init(1), tckpt.load(path))
    assert torch.equal(back.last_ep_env_success, ts.last_ep_env_success)
    assert torch.equal(back.last_ep_success, ts.last_ep_success)
    # a checkpoint without the tracker (an older or a single-agent one)
    # starts it at zero; a task without it drops the saved one
    ck = tckpt.load(path)
    ck.pop("last_ep_env_success")
    back2 = tckpt.restore(tr.init(2), ck)
    assert float(back2.last_ep_env_success.abs().max()) == 0.0
    no_tracker = dataclasses.replace(tr.init(3), last_ep_env_success=None)
    back3 = tckpt.restore(no_tracker, tckpt.load(path))
    assert back3.last_ep_env_success is None
    assert torch.equal(back3.last_ep_success, ts.last_ep_success)


def tiny_yaml(tmp_path, task, **config):
    with open(REPO / "airgym_tpu_torch" / "configs" / f"ppo_{task}.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["params"]["config"].update(horizon_length=H, minibatch_size=16,
                                   mini_epochs=2, max_epochs=2,
                                   save_best_after=1, **config)
    cfg["params"]["config"]["env_config"].update(CAM)
    cfg["params"]["network"]["cnn"]["output_dim"] = 8
    path = tmp_path / f"{task}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return cfg, path


@pytest.mark.parametrize("task,n", [("maplanning", E), ("avoid", 8)])
def test_cli_trains_on_cpu(task, n, tmp_path, monkeypatch):
    """The packaged YAML through the CLI at a small size: the plain
    trainer with frame dedup, the success rates, a checkpoint that
    reloads. MAPlanning's best-success checkpoint gates on the env-level
    rate, here made to succeed on every env."""
    if task == "maplanning":
        # every step is an env-level success: the gate has a rate to save
        from airgym_tpu_torch.envs import maplanning
        orig = maplanning.MAPlanning.step

        def step(self, *a, **kw):
            st, out = orig(self, *a, **kw)
            out.info["env_success"] = torch.ones_like(out.info["env_done"])
            out.info["env_done"] = torch.ones_like(out.info["env_done"])
            return st, out
        monkeypatch.setattr(maplanning.MAPlanning, "step", step)
    cfg, path = tiny_yaml(tmp_path, task, num_actors=n)
    monkeypatch.chdir(tmp_path)
    ts, info = cli.run_cli(["--train", "--task", task, "--file", str(path),
                            "--seed", "4", "--device", "cpu"])
    assert [r["epoch"] for r in info["history"]] == [1, 2]
    keys = ["mean_reward", "loss", "kl", "lr", "success_rate"]
    if task == "maplanning":
        keys.append("env_success_rate")
    for row in info["history"]:
        for k in keys:
            assert math.isfinite(row[k]) and (
                "success" not in k or 0.0 <= row[k] <= 1.0), k
    assert ("env_success_rate" in info["history"][0]) == (task == "maplanning")
    _, trainer, _ = Runner().load(cfg).build({"task": task, "device": "cpu"})
    assert type(trainer) is tppo.PPO and trainer.frame_dedup
    rows = n * R if task == "maplanning" else n
    assert ts.obs["image"].shape == (rows, 1, 32, 16)
    if task == "maplanning":
        assert info["best_success"] == 1.0
        best = pathlib.Path(info["run_dir"]) / "nn" / \
            "ppo_maplanning_best_success.pt"
        assert best.exists()
    back = tckpt.restore(trainer.init(9), tckpt.load(info["checkpoint"]))
    for k, v in ts.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[k], v), k
    assert pathlib.Path(info["checkpoint"][:-3] + ".pth").exists()


def test_transfer_checkpoint_refuses_naming_its_item(tmp_path):
    """The branch raised NotImplementedError naming ROADMAP.md queue A
    item 13b until that item was ported; it runs now
    (tests/test_torch_transfer.py). What it still refuses, loudly: a
    source checkpoint that is not there, and a source without its
    obs-vector width (the error names the missing argument)."""
    cfg, _ = tiny_yaml(tmp_path, "maplanning", num_actors=E)
    args = {"train": True, "task": "maplanning", "device": "cpu",
            "run_root": str(tmp_path)}
    with pytest.raises(FileNotFoundError):
        Runner().load(cfg).run({**args, "transfer_checkpoint": "x.pt",
                                "transfer_old_obs_dim": 20})
    _, trainer, _ = Runner().load(cfg).build(args)
    src = str(tmp_path / "src.pt")
    tckpt.save(src, trainer.init(0))
    with pytest.raises(ValueError, match="transfer_old_obs_dim"):
        Runner().load(cfg).run({**args, "transfer_checkpoint": src})
