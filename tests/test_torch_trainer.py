"""The port's fused Hovering trainer vs the JAX one, end to end.

A JAX FusedHoveringPPO TrainState is carried into the port with
``checkpoint.from_jax``; then one train epoch runs on each side from the
same env state with the same rollout-kernel seed (the JAX rollout kernel
in interpret mode, its update kernel interpreting by itself off-TPU).
obs_noise is off so that the bootstrap observation's jax.random noise
plays no part. Params and moments within 2e-3 * max|ref| + 1e-5 per
tensor, lr to rtol 1e-6, metrics to rtol 5e-3 / atol 5e-4 (the
tolerances of tests/test_fused_update.py)."""
import ast
import dataclasses
import functools
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
from airgym_tpu.ops import fused_rollout as jfr
from airgym_tpu.ops import fused_update as jfu
from airgym_tpu.rl import ppo as jppo
from airgym_tpu.rl import fused_ppo as jfused
from airgym_tpu.rl.fused_ppo import FusedHoveringPPO as JaxFusedPPO
from airgym_tpu_torch import cli
from airgym_tpu_torch.envs.balloon import BalloonState
from airgym_tpu_torch.envs.hovering import HoveringState
from airgym_tpu_torch.envs.tracking import TrackingState
from airgym_tpu_torch.ops import fused_update as tfu
from airgym_tpu_torch.rl import checkpoint as tckpt
from airgym_tpu_torch.rl import ppo as tppo
from airgym_tpu_torch.rl import fused_ppo as tfused
from airgym_tpu_torch.rl.fused_ppo import FusedHoveringPPO
from test_torch_env import to_port_core

N = 1024
SMALL = dict(horizon=4, minibatch_size=512, mini_epochs=3)
REPO = pathlib.Path(__file__).resolve().parents[1]


def _close_packs(ref, got):
    for f in tfu._FIELDS:
        a = np.asarray(getattr(ref, f))
        b = getattr(got, f).detach().numpy()
        scale = max(np.abs(a).max(), 1e-3)
        assert np.abs(a - b).max() < 2e-3 * scale + 1e-5, f


def test_train_epoch_from_jax_matches_jax(monkeypatch):
    monkeypatch.setattr(jfr, "rollout_fused_policy", functools.partial(
        jfr.rollout_fused_policy, interpret=True))
    jtask = jenvs.make_task("hovering", ctl_mode="rate", num_envs=N,
                            obs_noise=False)
    jtr = JaxFusedPPO(jtask, jppo.PPOConfig(**SMALL))
    ts_j = jtr.init(jax.random.PRNGKey(0))
    # the int32 seed the JAX rollout draws (rl/fused_ppo.rollout)
    _, k_seed, _ = jax.random.split(ts_j.rng, 3)
    seed = int(jax.random.randint(k_seed, (1,), 0, 2 ** 31 - 1,
                                  dtype=jnp.int32)[0])

    ttask = tenvs.make_task("hovering", ctl_mode="rate", num_envs=N,
                            obs_noise=False, device="cpu")
    ttr = FusedHoveringPPO(ttask, tppo.PPOConfig(**SMALL))
    host = lambda tree: jax.tree.map(np.asarray, tree)
    ck = tckpt.from_jax(host(ts_j.params), host(ts_j.obs_rms),
                        host(ts_j.value_rms),
                        adam_np=host(ts_j.opt_state[0]), lr=float(ts_j.lr))
    ts_t = tckpt.restore(ttr.init(0), ck)
    ts_t = dataclasses.replace(
        ts_t, env_state=HoveringState(core=to_port_core(ts_j.env_state.core)))
    _close_packs(jfu.pack_update(ts_j.params),
                 tfu.pack_update(dict(ts_t.model.named_parameters())))

    ts_j2, m_j = jax.jit(jtr.train_epoch)(ts_j)
    ts_t2, m_t = ttr.train_epoch(ts_t, seed=seed)

    _close_packs(jfu.pack_update(ts_j2.params),
                 tfu.pack_update(dict(ts_t2.model.named_parameters())))
    adam = ts_j2.opt_state[0]
    _close_packs(jfu.pack_update({"params": adam.mu["params"]}),
                 tfu.pack_update(ts_t2.adam["m"]))
    _close_packs(jfu.pack_update({"params": adam.nu["params"]}),
                 tfu.pack_update(ts_t2.adam["v"]))
    assert float(ts_t2.adam["count"][0]) == int(adam.count) == 8 * 3
    np.testing.assert_allclose(float(ts_t2.lr), float(ts_j2.lr), rtol=1e-6)
    for k in ("loss", "kl", "a_loss", "c_loss", "b_loss", "entropy",
              "clip_frac", "mean_reward", "reward_raw_per_step",
              "explained_variance"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=5e-3,
                                   atol=5e-4, err_msg=k)
    rms = ts_j2.obs_rms
    np.testing.assert_allclose(
        ts_t2.obs_rms.mean.numpy(),
        np.asarray(rms.mean, np.float64) + np.asarray(rms.mean_c), rtol=1e-5,
        atol=1e-7)
    np.testing.assert_allclose(ts_t2.env_state.core.root.numpy(),
                               np.asarray(ts_j2.env_state.core.root),
                               atol=1e-4)
    assert ts_t2.epoch == 1 and ts_t2.frame == N * SMALL["horizon"]


TASK_TRAINERS = {
    "balloon": (jfused.FusedBalloonPPO, tfused.FusedBalloonPPO),
    "tracking": (jfused.FusedTrackingPPO, tfused.FusedTrackingPPO),
}


def to_port_env_state(name, js):
    core = to_port_core(js.core)
    t = lambda a: torch.from_numpy(np.array(a))
    if name == "balloon":
        return BalloonState(core=core, balloon=t(js.balloon),
                            pre_root_pos=t(js.pre_root_pos))
    return TrackingState(core=core, pre_root_pos=t(js.pre_root_pos))


@pytest.mark.parametrize("name", ["balloon", "tracking"])
def test_task_train_epoch_from_jax_matches_jax(name, monkeypatch):
    """As the Hovering epoch above, for the Balloon and Tracking trainers
    (Tracking runs the update at 48 observation features); Balloon's
    success rate is compared too."""
    monkeypatch.setattr(jfr, "rollout_fused_policy", functools.partial(
        jfr.rollout_fused_policy, interpret=True))
    jcls, tcls = TASK_TRAINERS[name]
    jtask = jenvs.make_task(name, ctl_mode="rate", num_envs=N,
                            obs_noise=False)
    jtr = jcls(jtask, jppo.PPOConfig(**SMALL))
    ts_j = jtr.init(jax.random.PRNGKey(0))
    if name == "balloon":       # balloons next to 32 drones: hits, successes
        es = ts_j.env_state
        near = es.core.root[:32, 0:3] + jnp.array([0.05, 0.0, 0.0])
        ts_j = ts_j._replace(env_state=es._replace(
            balloon=es.balloon.at[:32, 0:3].set(near)))
    _, k_seed, _ = jax.random.split(ts_j.rng, 3)
    seed = int(jax.random.randint(k_seed, (1,), 0, 2 ** 31 - 1,
                                  dtype=jnp.int32)[0])

    ttask = tenvs.make_task(name, ctl_mode="rate", num_envs=N,
                            obs_noise=False, device="cpu")
    ttr = tcls(ttask, tppo.PPOConfig(**SMALL))
    host = lambda tree: jax.tree.map(np.asarray, tree)
    ck = tckpt.from_jax(host(ts_j.params), host(ts_j.obs_rms),
                        host(ts_j.value_rms),
                        adam_np=host(ts_j.opt_state[0]), lr=float(ts_j.lr))
    ts_t = tckpt.restore(ttr.init(0), ck)
    ts_t = dataclasses.replace(
        ts_t, env_state=to_port_env_state(name, ts_j.env_state))

    ts_j2, m_j = jax.jit(jtr.train_epoch)(ts_j)
    ts_t2, m_t = ttr.train_epoch(ts_t, seed=seed)

    _close_packs(jfu.pack_update(ts_j2.params),
                 tfu.pack_update(dict(ts_t2.model.named_parameters())))
    adam = ts_j2.opt_state[0]
    _close_packs(jfu.pack_update({"params": adam.mu["params"]}),
                 tfu.pack_update(ts_t2.adam["m"]))
    assert float(ts_t2.adam["count"][0]) == int(adam.count) == 8 * 3
    np.testing.assert_allclose(float(ts_t2.lr), float(ts_j2.lr), rtol=1e-6)
    keys = ["loss", "kl", "a_loss", "c_loss", "b_loss", "entropy",
            "clip_frac", "mean_reward", "reward_raw_per_step",
            "explained_variance"]
    if name == "balloon":
        keys.append("success_rate")
        assert 0.0 < float(m_t["success_rate"]) <= 1.0
    else:
        assert "success_rate" not in m_t and ts_t2.last_ep_success is None
    for k in keys:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=5e-3,
                                   atol=5e-4, err_msg=k)
    np.testing.assert_allclose(ts_t2.env_state.core.root.numpy(),
                               np.asarray(ts_j2.env_state.core.root),
                               atol=1e-4)
    np.testing.assert_allclose(ts_t2.env_state.pre_root_pos.numpy(),
                               np.asarray(ts_j2.env_state.pre_root_pos),
                               atol=1e-4)
    if name == "balloon":
        np.testing.assert_allclose(ts_t2.env_state.balloon.numpy(),
                                   np.asarray(ts_j2.env_state.balloon),
                                   atol=1e-5)
        np.testing.assert_array_equal(ts_t2.last_ep_success.numpy(),
                                      np.asarray(ts_j2.last_ep_success))
    np.testing.assert_allclose(ts_t2.obs.numpy(), np.asarray(ts_j2.obs),
                               atol=1e-4)


def test_cli_trains_saves_and_reloads_on_cpu(tmp_path, monkeypatch):
    with open(REPO / "airgym_tpu_torch" / "configs" / "ppo_hovering.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["params"]["config"].update(num_actors=N, horizon_length=4,
                                   minibatch_size=1024, mini_epochs=2,
                                   max_epochs=2, save_best_after=1)
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    argv = ["--train", "--task", "hovering", "--ctl_mode", "rate",
            "--file", str(path), "--seed", "3", "--device", "cpu"]
    ts, info = cli.run_cli(argv)
    assert [r["epoch"] for r in info["history"]] == [1, 2]
    for row in info["history"]:
        for k in ("mean_reward", "loss", "kl", "lr"):
            assert math.isfinite(row[k]), k
    assert pathlib.Path(info["checkpoint"]).exists()
    assert pathlib.Path(info["checkpoint"][:-3] + ".pth").exists()

    # reload into a fresh trainer state
    trainer = FusedHoveringPPO(
        tenvs.make_task("hovering", num_envs=N, device="cpu"),
        tppo.PPOConfig(horizon=4, minibatch_size=1024, mini_epochs=2))
    back = tckpt.restore(trainer.init(9), tckpt.load(info["checkpoint"]))
    for k, v in ts.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[k], v), k
    assert back.epoch == 2 and float(back.adam["count"][0]) == 2 * 4 * 2
    assert torch.equal(back.obs_rms.mean, ts.obs_rms.mean)

    # resume from it for one more epoch
    cfg["params"]["config"]["max_epochs"] = 3
    path.write_text(yaml.safe_dump(cfg))
    ts3, info3 = cli.run_cli(argv + ["--checkpoint", info["checkpoint"]])
    assert [r["epoch"] for r in info3["history"]] == [3]


@pytest.mark.parametrize("name", ["balloon", "tracking"])
def test_cli_trains_task_on_cpu(name, tmp_path, monkeypatch):
    """The packaged Balloon / Tracking YAMLs through the CLI at a small
    size; Balloon logs its success rate and keeps a best-success
    checkpoint (every episode end counted a success here, so that one is
    written)."""
    if name == "balloon":
        monkeypatch.setattr(tfused.FusedBalloonPPO, "_fused_success",
                            lambda self, obs, rewards, dones: dones)
    with open(REPO / "airgym_tpu_torch" / "configs" / f"ppo_{name}.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["params"]["config"].update(horizon_length=4, minibatch_size=1024,
                                   mini_epochs=2, max_epochs=2,
                                   save_best_after=1)
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    ts, info = cli.run_cli(["--train", "--task", name, "--ctl_mode", "rate",
                            "--num_envs", str(N), "--file", str(path),
                            "--device", "cpu"])
    assert [r["epoch"] for r in info["history"]] == [1, 2]
    for row in info["history"]:
        assert math.isfinite(row["mean_reward"]) and math.isfinite(row["kl"])
        assert ("success_rate" in row) == (name == "balloon")
    assert pathlib.Path(info["checkpoint"]).exists()
    if name == "balloon":
        assert 0.0 < info["best_success"] <= 1.0
        best = pathlib.Path(info["run_dir"]) / "nn" / \
            "ppo_balloon_best_success.pt"
        assert best.exists() and best.with_suffix(".pth").exists()
    else:
        assert "best_success" not in info


def test_balloon_yaml_env_count_raises_naming_7b(tmp_path, monkeypatch):
    """The Balloon YAML ships 64 envs, not a multiple of the kernel tile.
    That raised until queue A item 7b (the plain rollout and update) was
    ported; now the runner picks the plain trainer and it trains."""
    with open(REPO / "airgym_tpu_torch" / "configs" / "ppo_balloon.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["params"]["config"].update(horizon_length=8, minibatch_size=256,
                                   mini_epochs=2, max_epochs=1)
    path = tmp_path / "balloon64.yaml"
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    ts, info = cli.run_cli(["--train", "--task", "balloon", "--file",
                            str(path), "--device", "cpu"])
    assert ts.obs.shape == (64, 18) and info["epochs"] == 1
    assert math.isfinite(info["history"][0]["loss"])
    from airgym_tpu_torch.rl.runner import Runner
    _, trainer, _ = Runner().load(cfg).build({"task": "balloon",
                                             "device": "cpu"})
    assert type(trainer) is tppo.PPO


def test_cli_defaults_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.run_cli(["--train", "--task", "hovering", "--ctl_mode", "rate"])


@pytest.mark.parametrize("case", ["relu", "units", "separate", "num_envs",
                                  "clip_value"])
def test_configs_outside_the_slice_raise(case):
    """No fallback: what the fused kernels do not cover raises, naming
    the ROADMAP.md item that will port it. ``clip_value`` raised until
    the plain update was ported (queue A item 7b): the fused trainer now
    hands that update to it, as the JAX trainer does."""
    n = 1000 if case == "num_envs" else N
    task = tenvs.make_task("hovering", num_envs=n, device="cpu")
    net = {"relu": {"activation": "relu"}, "units": {"units": (32, 32)},
           "separate": {"separate": True}}.get(case, {})
    cfg = tppo.PPOConfig(**SMALL, clip_value=case == "clip_value")
    if case == "clip_value":
        trainer = FusedHoveringPPO(task, cfg, network_kw=net)
        ts, m = trainer.train_epoch(trainer.init(0))
        assert math.isfinite(float(m["loss"]))
        assert float(ts.adam["count"][0]) == 8 * 3
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trainer = FusedHoveringPPO(task, cfg, network_kw=net)
        trainer.train_epoch(trainer.init(0))


@pytest.mark.parametrize("case", [
    "hovering", "balloon_64", "num_envs_1000", "ctl_mode_pos", "relu",
    "units", "separate", "fixed_sigma_off", "use_fused_rollout_off",
    "tracking"])
def test_runner_and_refusal_agree_on_the_fused_trainer(case):
    """``Runner.build`` takes the task's fused trainer exactly where the
    YAML asks for it and ``refusal`` returns None, and the fused class
    refuses to be built for the reason ``refusal`` gives: the shipped
    Hovering and Tracking YAMLs fuse; Balloon's 64 envs, 1000 envs, pos
    mode and each other net take the plain PPO."""
    from airgym_tpu_torch.rl.runner import Runner
    name = {"balloon_64": "balloon", "tracking": "tracking"}.get(
        case, "hovering")
    with open(REPO / "airgym_tpu_torch" / "configs" / f"ppo_{name}.yaml") as f:
        cfg = yaml.safe_load(f)
    net, args = cfg["params"]["network"], {"task": name, "device": "cpu"}
    if case == "num_envs_1000":
        args["num_envs"] = 1000
    elif case == "ctl_mode_pos":
        args["ctl_mode"] = "pos"
    elif case == "relu":
        net["mlp"]["activation"] = "relu"
    elif case == "units":
        net["mlp"]["units"] = [32, 32]
    elif case == "separate":
        net["separate"] = True
    elif case == "fixed_sigma_off":
        net["space"]["continuous"]["fixed_sigma"] = False
    elif case == "use_fused_rollout_off":
        cfg["params"]["config"]["use_fused_rollout"] = False
    runner = Runner().load(cfg)
    task, trainer, _ = runner.build(args)
    cls = tfused.FUSED_TRAINERS[name]
    reason = cls.refusal(task, runner.network_kw())
    fused = case in ("hovering", "tracking")
    assert (reason is None) == (fused or case == "use_fused_rollout_off")
    assert type(trainer) is (cls if fused else tppo.PPO)
    if reason is not None:
        with pytest.raises(NotImplementedError) as err:
            cls(task, trainer.cfg, network_kw=runner.network_kw())
        assert reason in str(err.value)


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "airgym_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    banned = ("jax", "jaxlib", "flax", "optax", "airgym_tpu")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in banned, f"{path}: imports {name}"
