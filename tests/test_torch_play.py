"""The port's play / eval path and the run's records against the JAX
package: the ``Player``, the runner's play dispatch and training dumps,
the CLI, the metrics writer and the timers.

Player parity: Hovering at 64 envs, obs noise off, the plain PPO on both
sides, the JAX params carried in with ``checkpoint.from_jax``, both
players booted from the JAX task's initial state (the port task's
``initial_state`` patched to return it, converted). One chunk of 50
steps: per env, rewards within atol 1e-4 and reset flags equal up to
that env's first reset (after it the two frameworks' reset draws
differ)."""
import json
import math
import os
import pathlib
import time

import jax
import numpy as np
import pytest
import torch
import yaml

import airgym_tpu.envs as jenvs
import airgym_tpu_torch.envs as tenvs
from airgym_tpu.rl import ppo as jppo
from airgym_tpu.rl.runner import Player as JaxPlayer
from airgym_tpu_torch import cli
from airgym_tpu_torch.envs.hovering import HoveringState
from airgym_tpu_torch.rl import checkpoint as tckpt
from airgym_tpu_torch.rl import metrics as tmetrics
from airgym_tpu_torch.rl import ppo as tppo
from airgym_tpu_torch.rl import profiling as tprof
from airgym_tpu_torch.rl import runner as trunner
from airgym_tpu_torch.rl.runner import Player
from airgym_tpu_torch.utils.episode_viz import _euler_from_quat, dump_episode
from test_torch_env import to_port_core

REPO = pathlib.Path(__file__).resolve().parents[1]
N = 64
SMALL = dict(horizon=4, minibatch_size=64, mini_epochs=1)


def tiny_yaml(tmp_path, task="hovering", **config):
    with open(REPO / "airgym_tpu_torch" / "configs" / f"ppo_{task}.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["params"]["config"].update({
        "num_actors": 16, "horizon_length": 4, "minibatch_size": 32,
        "mini_epochs": 1, "max_epochs": 2, "save_best_after": 1, **config})
    path = tmp_path / f"{task}_tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return cfg, str(path)


def test_player_matches_jax_player(tmp_path, monkeypatch):
    jt = jenvs.make_task("hovering", ctl_mode="rate", num_envs=N,
                         obs_noise=False)
    tt = tenvs.make_task("hovering", ctl_mode="rate", num_envs=N,
                         obs_noise=False, device="cpu")
    jtr = jppo.PPO(jt, jppo.PPOConfig(**SMALL))
    ttr = tppo.PPO(tt, tppo.PPOConfig(**SMALL))
    jplayer = JaxPlayer(jt, jtr)
    # a policy whose obs stats are not the identity, on both sides
    rng = np.random.default_rng(0)
    seen = rng.normal(0.0, 2.0, (256, 18)).astype(np.float32)
    jplayer.ts = jplayer.ts._replace(
        obs_rms=jplayer.ts.obs_rms.update(jax.numpy.asarray(seen)))
    host = lambda tree: jax.tree.map(np.asarray, tree)
    ck = tckpt.from_jax(host(jplayer.ts.params), host(jplayer.ts.obs_rms),
                        host(jplayer.ts.value_rms))
    player = Player(tt, ttr)
    player.ts = tckpt.restore(player.ts, ck)

    js0 = jt.initial_state(jax.random.PRNGKey(0))
    monkeypatch.setattr(tt, "initial_state", lambda generator: HoveringState(
        core=to_port_core(js0.core)))
    out_j = jplayer.run(max_steps=50, seed=0, chunk=50,
                        record_dir=str(tmp_path / "jax"))
    rec_j = np.load(tmp_path / "jax" / "episode.npz")
    rec_t = player.rollout(50, seed=0, chunk=50)
    out_t = player.run(max_steps=50, seed=0, chunk=50)
    assert rec_t["reward"].shape == rec_j["reward"].shape == (50, N)
    resets_j = rec_j["reset"]
    assert resets_j.any() and not resets_j.all(axis=0).any()
    for e in range(N):
        hit = np.flatnonzero(resets_j[:, e])
        end = hit[0] + 1 if hit.size else 50
        np.testing.assert_allclose(rec_t["reward"][:end, e],
                                   rec_j["reward"][:end, e], atol=1e-4,
                                   err_msg=f"env {e}")
        np.testing.assert_array_equal(rec_t["reset"][:end, e],
                                      resets_j[:end, e], err_msg=f"env {e}")
    assert out_t["steps"] == out_j["steps"] == 50
    assert set(out_t) == set(out_j)


def balloon_player(seed=0):
    task = tenvs.make_task("balloon", ctl_mode="rate", num_envs=N,
                           device="cpu")
    return Player(task, tppo.PPO(task, tppo.PPOConfig(**SMALL)))


def test_player_success_rate_counts_success_at_resets(monkeypatch, capsys):
    """success_rate = sum(success & reset) / games: a task that flags
    success on every step of the even envs counts only the even envs'
    episode ends."""
    player = balloon_player()
    step = player.task.step
    seen = []

    def flagged(state, actions, generator):
        state, out = step(state, actions, generator)
        even = torch.arange(N) % 2 == 0
        out.info["success"] = even
        seen.append(out.reset.clone())
        return state, out

    monkeypatch.setattr(player.task, "step", flagged)
    out = player.run(max_steps=60, seed=1, chunk=30)
    resets = torch.stack(seen[1:])              # without the boot step
    games = int(resets.sum())
    assert out["games"] == games > 0
    assert out["success_rate"] == pytest.approx(
        int(resets[:, ::2].sum()) / games)
    assert 0.0 < out["success_rate"] < 1.0
    line = capsys.readouterr().out
    assert f"games played: {games}" in line and "success_rate:" in line


def test_player_games_num_early_stop():
    """Play stops at the first chunk boundary after games_num episodes
    have finished (a fresh Balloon policy ends episodes within steps)."""
    out = balloon_player().run(max_steps=1000, seed=0, chunk=50,
                               games_num=1)
    assert out["games"] >= 1 and out["steps"] == 50
    full = balloon_player().run(max_steps=100, seed=0, chunk=50)
    assert full["steps"] == 100 and "success_rate" in full


def test_player_restores_pt_and_pth_alike(tmp_path):
    src = balloon_player()
    ts = src.trainer.init(11)
    ts.obs_rms = ts.obs_rms.update(torch.randn(512, 18) * 3 + 1)
    path = str(tmp_path / "ck")
    trunner.Runner.save(ts, path, 1.5)
    a, b, fresh = balloon_player(), balloon_player(), balloon_player()
    a.restore(path + ".pt")
    b.restore(path + ".pth")
    probe = torch.randn(32, 18)
    with torch.no_grad():
        mu_ref = ts.model(probe, ts.obs_rms)[0]
        mu_a = a.ts.model(probe, a.ts.obs_rms)[0]
        mu_b = b.ts.model(probe, b.ts.obs_rms)[0]
        mu_f = fresh.ts.model(probe, fresh.ts.obs_rms)[0]
    torch.testing.assert_close(mu_a, mu_ref, rtol=0, atol=0)
    torch.testing.assert_close(mu_b, mu_ref, rtol=0, atol=1e-6)
    assert not torch.allclose(mu_f, mu_ref)


def test_player_records_vision_and_state_tasks(tmp_path):
    task = tenvs.make_task("planning", ctl_mode="rate", num_envs=4,
                           num_trees=6, cam_width=64, cam_height=32,
                           device="cpu")
    tr = tppo.PPO(task, tppo.PPOConfig(horizon=8, minibatch_size=8,
                                       mini_epochs=1))
    out = Player(task, tr).run(max_steps=20, chunk=10,
                               record_dir=str(tmp_path / "viz"))
    assert out["steps"] == 20
    for f in ("trajectory.png", "depth.gif", "episode.npz"):
        assert (tmp_path / "viz" / f).exists(), f
    rec = np.load(tmp_path / "viz" / "episode.npz")
    assert rec["camera"].shape == (20, 64, 32)
    assert rec["root"].shape == (20, 4, 13)

    task = tenvs.make_task("hovering", ctl_mode="rate", num_envs=4,
                           device="cpu")
    tr = tppo.PPO(task, tppo.PPOConfig(horizon=8, minibatch_size=8,
                                       mini_epochs=1))
    Player(task, tr).run(max_steps=20, chunk=10,
                         record_dir=str(tmp_path / "viz2"))
    assert (tmp_path / "viz2" / "trajectory.png").exists()
    assert (tmp_path / "viz2" / "episode.npz").exists()
    assert not (tmp_path / "viz2" / "depth.gif").exists()


def test_dump_episode_and_euler_match_jax(tmp_path):
    from airgym_tpu.utils import episode_viz as jviz
    rng = np.random.default_rng(2)
    q = rng.normal(size=(40, 2, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    np.testing.assert_allclose(_euler_from_quat(q), jviz._euler_from_quat(q),
                               atol=1e-12)
    rec = {"root": rng.normal(size=(40, 2, 13)).astype(np.float32),
           "reward": rng.random((40, 5)).astype(np.float32),
           "reset": np.zeros((40, 5), bool),
           "camera": rng.random((40, 32, 24)).astype(np.float32)}
    rec["root"][..., 3:7] = q
    dump_episode(str(tmp_path), rec)
    for f in ("trajectory.png", "depth.gif", "episode.npz"):
        assert (tmp_path / f).exists(), f
    back = np.load(tmp_path / "episode.npz")
    assert sorted(back.files) == sorted(rec)


def test_runner_viz_every_epochs_dumps(tmp_path):
    cfg, _ = tiny_yaml(tmp_path, viz_every_epochs=2, max_epochs=4)
    runner = trunner.Runner().load(cfg)
    ts, info = runner.run({"train": True, "task": "hovering",
                           "ctl_mode": "rate", "num_envs": 16, "seed": 3,
                           "run_root": str(tmp_path), "log_every": 1,
                           "device": "cpu"})
    viz = pathlib.Path(info["run_dir"]) / "viz"
    assert sorted(os.listdir(viz)) == ["epoch_000002", "epoch_000004"]
    for d in ("epoch_000002", "epoch_000004"):
        assert (viz / d / "trajectory.png").exists()
        rec = np.load(viz / d / "episode.npz")
        assert rec["root"].shape == (200, 4, 13)
    # the dumps ran on fresh env batches: the training state went on
    assert ts.epoch == 4 and ts.frame == 4 * 16 * 4


def test_cli_train_then_play_on_cpu(tmp_path, monkeypatch, capsys):
    _, path = tiny_yaml(tmp_path)
    monkeypatch.chdir(tmp_path)
    base = ["--task", "hovering", "--file", path, "--device", "cpu"]
    ts, info = cli.run_cli(["--train", "--experiment_name", "exp"] + base)
    run_dir = pathlib.Path(info["run_dir"])
    assert run_dir.name.startswith("exp_")
    assert (run_dir / "nn" / "last_exp.pth").exists()
    events = [json.loads(l) for l in
              (run_dir / "events.jsonl").read_text().splitlines()]
    tags = {e["tag"] for e in events}
    for tag in ("losses/a_loss", "losses/c_loss", "losses/bounds_loss",
                "losses/entropy", "info/last_lr", "info/kl", "info/epochs",
                "performance/step_inference_rl_update_fps", "rewards/frame",
                "rewards/iter", "episode_lengths/frame",
                "diagnostics/clip_frac", "diagnostics/explained_variance"):
        assert tag in tags, tag
    assert any(t.startswith("Episode/") for t in tags)
    assert {e["step"] for e in events} == {16 * 4, 2 * 16 * 4}
    assert all(math.isfinite(e["value"]) for e in events)
    capsys.readouterr()

    out = cli.run_cli(["--play", "--checkpoint",
                       str(run_dir / "nn" / "last_exp.pth"),
                       "--max_steps", "100", "--headless"] + base)
    assert out["steps"] == 100 and math.isfinite(out["mean_reward"])
    assert "av reward:" in capsys.readouterr().out
    # the training flag wins, and neither flag trains
    base = ["--task", "hovering"]
    assert cli.resolve_train(cli.get_args(base + ["--train"]))
    assert not cli.resolve_train(cli.get_args(base + ["--play"]))
    assert cli.resolve_train(cli.get_args(base))
    assert cli.resolve_train(cli.get_args(base + ["--train", "--play"]))
    args = cli.get_args(base + ["--experiment_name", "x", "--num_envs",
                                "32", "--seed", "0"])
    cfg = cli.update_config({"params": {"config": {}}}, args)
    assert cfg["params"]["config"] == {"env_name": "hovering", "name": "x",
                                       "num_actors": 32}
    assert cfg["params"]["seed"] == 0 and args.ctl_mode == "rate"


def test_play_defaults_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.run_cli(["--play", "--task", "hovering"])


def test_metrics_writer_jsonl_and_tensorboard(tmp_path):
    w = tmetrics.MetricsWriter(str(tmp_path / "a"), use_tensorboard=False)
    w.add_scalars({"losses/a_loss": 0.5, "Episode/reward": 1.25}, step=7)
    w.close()
    lines = [json.loads(l) for l in
             (tmp_path / "a" / "events.jsonl").read_text().splitlines()]
    assert lines == [{"tag": "losses/a_loss", "value": 0.5, "step": 7},
                     {"tag": "Episode/reward", "value": 1.25, "step": 7}]
    assert not (tmp_path / "a" / "summaries").exists()
    try:
        from torch.utils.tensorboard import SummaryWriter  # noqa: F401
        have_tb = True
    except Exception:
        have_tb = False
    w = tmetrics.MetricsWriter(str(tmp_path / "b"))
    w.add_scalars({"rewards/frame": 3.0}, step=1)
    w.close()
    assert (tmp_path / "b" / "events.jsonl").exists()
    summaries = tmp_path / "b" / "summaries"
    assert summaries.exists() == have_tb
    if have_tb:
        assert any(f.startswith("events.out.tfevents")
                   for f in os.listdir(summaries))


def test_interval_writer_throttles_and_episode_terms(tmp_path):
    w = tmetrics.MetricsWriter(str(tmp_path), use_tensorboard=False)
    iw = tmetrics.IntervalWriter(w, defer_start=1e9, interval_frac=0.0,
                                 min_interval=100.0)
    iw.add_scalars({"a": 1.0}, 0)          # the first write goes through
    iw.add_scalars({"a": 2.0}, 1)          # throttled
    late = tmetrics.IntervalWriter(w, defer_start=0.0, interval_frac=0.0,
                                   min_interval=0.0)
    late.add_scalars({"b": 3.0}, 2)
    late.add_scalars({"b": 4.0}, 3)
    w.close()
    lines = [json.loads(l)["tag"] for l in
             (tmp_path / "events.jsonl").read_text().splitlines()]
    assert lines == ["a", "b", "b"]
    from airgym_tpu.rl import metrics as jmetrics
    info = {"pos_reward": np.array([1.0, 3.0], np.float32)}
    assert tmetrics.episode_terms(info) == jmetrics.episode_terms(info) == {
        "Episode/pos_reward": 2.0}
    assert tmetrics.episode_terms(
        {"pos_reward": torch.tensor([1.0, 3.0])}) == {
        "Episode/pos_reward": 2.0}


def test_step_timer_and_traces(tmp_path):
    t = tprof.StepTimer()
    with t.play():
        with t.env_step():
            time.sleep(0.01)
    with t.update():
        time.sleep(0.01)
    t.add_frames(1000)
    fps = t.fps()
    assert set(fps) == {"performance/step_fps",
                        "performance/step_inference_fps",
                        "performance/step_inference_rl_update_fps"}
    assert fps["performance/step_fps"] >= \
        fps["performance/step_inference_fps"] > \
        fps["performance/step_inference_rl_update_fps"] > 0
    t.reset()
    assert t.frames == 0 and t.play_time == 0.0
    with tprof.device_trace(None):
        pass
    with tprof.device_trace(str(tmp_path / "trace")):
        with tprof.annotate("span"):
            torch.ones(4).sum()
    assert any(f.endswith(".json") for f in os.listdir(tmp_path / "trace"))

