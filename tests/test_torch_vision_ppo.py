"""The port's vision PPO vs the JAX package: the CNN encoder, the
vision checkpoint bridge, the frame-dedup loss and update on the same
dataset, the minibatch windows, and a CPU training run of Planning.

Tolerances: the CNN in float32 to 1e-5 (the JAX stack's folded and
space-to-depth convs sum in another order); in bfloat16 the two
frameworks round at different places (XLA fuses the bias and batch-norm
steps and rounds once, PyTorch rounds after each op), so features agree
to 3e-2 * max|ref| + 1e-3, a few bf16 ulps through three layers. The
update: params and Adam moments within 2e-3 * max|ref| + 1e-5 per tensor,
lr to rtol 1e-6, metrics to rtol 5e-3 / atol 5e-4 (as
tests/test_fused_update.py)."""
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
from airgym_tpu.rl import checkpoint as jckpt
from airgym_tpu.rl import ppo as jppo
from airgym_tpu.rl.running_stats import RunningMeanStd as JaxRMS
from airgym_tpu_torch import cli
from airgym_tpu_torch.models import actor_critic as tac
from airgym_tpu_torch.rl import checkpoint as tckpt
from airgym_tpu_torch.rl import ppo as tppo
from airgym_tpu_torch.rl import profiling
from airgym_tpu_torch.rl.running_stats import RunningMeanStd
from test_torch_ppo import close_tensors, jax_named, to_jax, to_torch

N, H = 8, 8
W_, H_ = 32, 16
CAM = dict(cam_width=W_, cam_height=H_)
SMALL = dict(horizon=H, minibatch_size=16, mini_epochs=2)
REPO = pathlib.Path(__file__).resolve().parents[1]
host = lambda tree: jax.tree.map(np.asarray, tree)


def model_pair(dtype):
    """A JAX CNN actor-critic and the port's with the same parameters."""
    jdt = None if dtype is None else jnp.bfloat16
    jm = jac.ActorCritic(num_actions=4, image_encoder="cnn",
                         cnn_compute_dtype=jdt)
    sample = {"image": jnp.zeros((1, 1, W_, H_)),
              "observation": jnp.zeros((1, 16))}
    params = jm.init(jax.random.PRNGKey(3), sample)
    # non-trivial batch-norm statistics and scales
    rng = np.random.default_rng(4)
    p = host(params)
    for i, c in ((0, 16), (1, 32), (2, 64)):
        bn = p["params"]["actor_cnn"][f"bn{i}"]
        bn["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        bn["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        bn["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
    params = jax.tree.map(jnp.asarray, p)
    tm = tac.ActorCritic(16, 4, image_encoder="cnn", cnn_compute_dtype=dtype)
    tm.load_state_dict(tckpt.from_jax(host(params), None, None)["model"])
    return jm, params, tm


def obs_and_stats(seed=5, b=12, feat=30):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 3.0, (b, 1, W_, H_)).astype(np.float32)
    vec = rng.normal(0, 1, (b, 16)).astype(np.float32)
    stat_img = rng.uniform(0.0, 3.0, (64, 1, W_, H_)).astype(np.float32)
    stat_vec = rng.normal(0.5, 2.0, (64, 16 + feat)).astype(np.float32)
    j_rms = {"image": JaxRMS.create((1, W_, H_)).update(jnp.asarray(stat_img)),
             "observation": JaxRMS.create((16 + feat,)).update(
                 jnp.asarray(stat_vec))}
    t_rms = {"image": RunningMeanStd.create((1, W_, H_)).update(
                 torch.from_numpy(stat_img)),
             "observation": RunningMeanStd.create((16 + feat,)).update(
                 torch.from_numpy(stat_vec))}
    return img, vec, j_rms, t_rms


@pytest.mark.parametrize("dtype", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cnn_actor_critic_matches_jax(dtype):
    jm, params, tm = model_pair(dtype)
    img, vec, j_rms, t_rms = obs_and_stats()
    jobs = {"image": jnp.asarray(img), "observation": jnp.asarray(vec)}
    tobs = {"image": torch.from_numpy(img), "observation": torch.from_numpy(vec)}
    enc = jac.CNNEncoder(compute_dtype=None if dtype is None
                         else jnp.bfloat16)
    f_ref = np.asarray(enc.apply({"params": params["params"]["actor_cnn"]},
                                 j_rms["image"].normalize(jobs["image"])))
    with torch.no_grad():
        f_got = tm.encode_image(tobs["image"], t_rms).numpy()
        mu_t, _, v_t = tm(tobs, t_rms)
    mu_j, _, v_j = jm.apply(params, jobs, j_rms)
    assert f_got.shape == (12, 30)
    if dtype is None:
        np.testing.assert_allclose(f_got, f_ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), atol=1e-5)
        np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-5)
    else:
        scale = np.abs(f_ref).max()
        assert np.abs(f_got - f_ref).max() < 3e-2 * scale + 1e-3
        assert np.abs(mu_t.numpy() - np.asarray(mu_j)).max() < 3e-3
        assert np.abs(v_t.numpy() - np.asarray(v_j)).max() < 3e-3


def test_from_jax_and_pth_both_ways(tmp_path):
    jm, params, tm = model_pair(None)
    img, vec, j_rms, t_rms = obs_and_stats(seed=6)
    ck = tckpt.from_jax(host(params), host(j_rms), None)
    sd = tm.state_dict()
    assert set(ck["model"]) == set(sd)
    np.testing.assert_array_equal(
        sd["actor_cnn.features.0.weight"].numpy(),
        np.transpose(np.asarray(params["params"]["actor_cnn"]["conv0"]
                                ["kernel"]), (3, 2, 0, 1)))
    for k in ("image", "observation"):
        np.testing.assert_allclose(ck["obs_rms"][k]["mean"].numpy(),
                                   t_rms[k].mean.numpy(), rtol=1e-6,
                                   atol=1e-7)
    jobs = {"image": jnp.asarray(img), "observation": jnp.asarray(vec)}
    tobs = {"image": torch.from_numpy(img), "observation": torch.from_numpy(vec)}
    mu_ref = np.asarray(jm.apply(params, jobs, j_rms)[0])

    # port -> JAX
    vr = RunningMeanStd.create(()).update(torch.randn(100, dtype=torch.float64))
    ts = type("TS", (), dict(model=tm, obs_rms=t_rms, value_rms=vr, epoch=3,
                             frame=99))()
    path = str(tmp_path / "port.pth")
    tckpt.export_pth(path, ts, 1.5)
    p2, orms, vrms, meta = jckpt.import_pth(
        path, params, {"image": JaxRMS.create((1, W_, H_)),
                       "observation": JaxRMS.create((46,))},
        JaxRMS.create(()))
    np.testing.assert_allclose(np.asarray(jm.apply(p2, jobs, orms)[0]),
                               mu_ref, atol=1e-5)
    assert meta["epoch"] == 3

    # JAX -> port
    jts = type("JTS", (), dict(params=params, obs_rms=j_rms,
                               value_rms=JaxRMS.create(()), epoch=7,
                               frame=jppo.frame_from_int(5)))()
    path2 = str(tmp_path / "jax.pth")
    jckpt.export_pth(path2, jts, 2.0)
    m2 = tac.ActorCritic(16, 4, image_encoder="cnn", cnn_compute_dtype=None)
    t_orms, _, meta2 = tckpt.import_pth(
        path2, m2, {"image": RunningMeanStd.create((1, W_, H_)),
                    "observation": RunningMeanStd.create((46,))},
        RunningMeanStd.create(()))
    with torch.no_grad():
        mu2 = m2(tobs, t_orms)[0].numpy()
    np.testing.assert_allclose(mu2, mu_ref, atol=1e-5)
    assert meta2["epoch"] == 7


def vision_pair(cnn_impl="auto", image_encoder="cnn"):
    """The JAX and the port's Planning trainers at one state; ``cnn_impl``
    is the port's CNN path, 'pallas' against the JAX package's
    'pallas_interpret'."""
    net = dict(image_encoder=image_encoder, cnn_compute_dtype=None)
    jimpl = "pallas_interpret" if cnn_impl == "pallas" else cnn_impl
    jt = jppo.PPO(jenvs.make_task("planning", num_envs=N, **CAM),
                  jppo.PPOConfig(**SMALL),
                  network_kw=dict(net, cnn_impl=jimpl))
    tt = tppo.PPO(tenvs.make_task("planning", num_envs=N, device="cpu",
                                  **CAM),
                  tppo.PPOConfig(**SMALL),
                  network_kw=dict(net, cnn_impl=cnn_impl))
    ts_j = jt.init(jax.random.PRNGKey(0))
    feat = 64 if image_encoder == "vae" else 30     # the defaults' widths
    _, _, j_rms, _ = obs_and_stats(seed=7, feat=feat)
    ts_j = ts_j._replace(obs_rms=j_rms)
    ck = tckpt.from_jax(host(ts_j.params), host(ts_j.obs_rms),
                        host(ts_j.value_rms),
                        adam_np=host(ts_j.opt_state[0]), lr=float(ts_j.lr))
    ts_t = tckpt.restore(tt.init(0), ck)
    return jt, tt, ts_j, ts_t


def vision_dataset(seed=8):
    rng = np.random.default_rng(seed)
    B, F = N * H, H // 4 + 1
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    mus = 0.3 * f(B, 4)
    actions = mus + f(B, 4)
    nlp = (0.5 * np.sum((actions - mus) ** 2, -1)
           + 0.5 * np.log(2 * np.pi) * 4).astype(np.float32)
    # frames exactly representable in bf16, stored bf16 on both sides
    frames = torch.from_numpy(rng.uniform(0.0, 3.0, (F, N, 1, W_, H_)).astype(
        np.float32)).to(torch.bfloat16)
    d = {"obs": {"observation": f(B, 16)}, "actions": actions,
         "neglogp": nlp + 0.05 * f(B), "values": f(B), "returns": f(B),
         "adv": f(B), "mus_init": mus,
         "sigmas_init": np.ones((B, 4), np.float32),
         "frame_idx": (np.arange(H) // 4).astype(np.int32)}
    return d, frames


@pytest.mark.parametrize("cnn_impl,image_encoder", [
    pytest.param("auto", "cnn", id="auto"),
    pytest.param("pallas", "cnn", id="pallas"),
    pytest.param("auto", "resnet", id="resnet"),
    pytest.param("auto", "vae", id="vae")])
def test_vision_loss_and_update_match_jax(cnn_impl, image_encoder):
    """The CNN, and the frozen ResNet-18 and VAE, whose update keeps the
    head's input from the first mini-epoch and runs the head alone on it
    in the second (``encode_hit``), where the JAX package re-encodes."""
    jt, tt, ts_j, ts_t = vision_pair(cnn_impl, image_encoder)
    if image_encoder == "cnn":
        assert ts_t.model.actor_cnn.impl == cnn_impl
    assert tt.frame_dedup and jt.frame_dedup and tt.num_frames == 3
    d, frames = vision_dataset()
    dj, dt = to_jax(d), to_torch(d)
    dj["frames"] = jnp.asarray(frames.float().numpy()).astype(jnp.bfloat16)
    dt["frames"] = frames
    dt["frame_idx"] = dt["frame_idx"].long()

    # the loss of minibatch 1 through its unique-frame window
    k, mb = 1, 16
    img_u, idx = tt.unique_window(dt["frames"], dt["frame_idx"], k, mb)
    sl = slice(k * mb, (k + 1) * mb)
    mb_t = {key: v[sl] for key, v in dt.items()
            if key not in ("obs", "frames", "frame_idx")}
    mb_t["obs"] = {"observation": dt["obs"]["observation"][sl],
                   "image_unique": img_u, "feat_index": idx}
    mb_t["mus"], mb_t["sigmas"] = mb_t["mus_init"], mb_t["sigmas_init"]
    mb_j = {key: jnp.asarray(v.float().numpy() if v.dtype == torch.bfloat16
                             else v.numpy()) for key, v in mb_t.items()
            if key != "obs"}
    mb_j["obs"] = {"observation": jnp.asarray(mb_t["obs"]["observation"]),
                   "image_unique": jnp.asarray(img_u.float().numpy()).astype(
                       jnp.bfloat16),
                   "feat_index": jnp.asarray(idx.numpy())}
    loss_j, aux_j = jt._loss_fn(ts_j.params, ts_j.obs_rms, ts_j.value_rms,
                                mb_j)
    loss_t, aux_t = tt._loss_fn(ts_t.model, ts_t.obs_rms, ts_t.value_rms,
                                mb_t)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5, atol=1e-6)
    for key in ("a_loss", "c_loss", "kl", "clip_frac"):
        np.testing.assert_allclose(float(aux_t[key]), float(aux_j[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)

    # one whole update phase
    ts_j2, m_j = jax.jit(jt.update)(ts_j, dj)
    profiling.start()
    try:
        ts_t2, m_t = tt.update(ts_t, dt)
    finally:
        hits = [r.name for r in profiling.stop()].count("encode_hit")
    assert hits == (0 if image_encoder == "cnn" else 4)
    params_t = dict(ts_t2.model.named_parameters())
    ref = jax_named(ts_j2.params)
    close_tensors({k: v for k, v in ref.items() if k in params_t}, params_t)
    # the frozen batch-norm statistics stay as they were on both sides
    sd = ts_t2.model.state_dict()
    for k in ref:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_array_equal(sd[k].numpy(), ref[k], err_msg=k)
    adam = ts_j2.opt_state[0]
    named_m = {k: v for k, v in jax_named(adam.mu).items()
               if k in ts_t2.adam["m"]}
    close_tensors(named_m, ts_t2.adam["m"])
    assert float(ts_t2.adam["count"][0]) == int(adam.count) == 2 * 4
    np.testing.assert_allclose(float(ts_t2.lr), float(ts_j2.lr), rtol=1e-6)
    for key in tppo.METRICS:
        np.testing.assert_allclose(float(m_t[key]), float(m_j[key]),
                                   rtol=5e-3, atol=5e-4, err_msg=key)


@pytest.mark.parametrize("n_envs,mb", [(8, 16), (2, 16), (8, 64)])
def test_unique_window_and_scan_layout_indices(n_envs, mb):
    """Every sample of every minibatch finds its own frame; (2, 16) needs
    3 envs of window from 2 envs, the case the reference's
    _mb_from_scan_layout does not clamp."""
    task = tenvs.make_task("planning", num_envs=n_envs, device="cpu", **CAM)
    tr = tppo.PPO(task, tppo.PPOConfig(horizon=H, minibatch_size=mb,
                                       mini_epochs=1))
    F = tr.num_frames
    frames = torch.arange(F * n_envs, dtype=torch.float32).reshape(
        F, n_envs, 1, 1, 1).expand(F, n_envs, 1, 2, 2).contiguous()
    frame_idx = torch.arange(H) // 4
    images = torch.arange(H * n_envs, dtype=torch.float32).reshape(
        H, n_envs, 1, 1, 1).expand(H, n_envs, 1, 2, 2).contiguous()
    flat = images.transpose(0, 1).reshape(H * n_envs, 1, 2, 2)
    for k in range(tr.num_minibatches):
        img_u, idx = tr.unique_window(frames, frame_idx, k, mb)
        j = k * mb + torch.arange(mb)
        want = frames[frame_idx[j % H], j // H]
        assert torch.equal(img_u[idx], want)
        assert img_u.shape[0] == F * min(-(-mb // H) + 1, n_envs)
        assert torch.equal(tr._mb_from_scan_layout(images, k, mb),
                           flat[k * mb:(k + 1) * mb])


def test_cli_trains_planning_on_cpu(tmp_path, monkeypatch):
    """The packaged Planning YAML through the CLI at a small size: the
    plain trainer, frame dedup, a success rate and a best-success
    checkpoint slot, and a checkpoint that reloads."""
    with open(REPO / "airgym_tpu_torch" / "configs" / "ppo_planning.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["params"]["config"].update(num_actors=N, horizon_length=H,
                                   minibatch_size=32, mini_epochs=2,
                                   max_epochs=2, save_best_after=1)
    cfg["params"]["config"]["env_config"].update(CAM)
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    ts, info = cli.run_cli(["--train", "--task", "planning", "--file",
                            str(path), "--seed", "4", "--device", "cpu"])
    assert [r["epoch"] for r in info["history"]] == [1, 2]
    for row in info["history"]:
        for k in ("mean_reward", "loss", "kl", "lr", "success_rate"):
            assert math.isfinite(row[k]), k
    assert "best_success" in info
    assert ts.obs["image"].shape == (N, 1, W_, H_)
    assert set(ts.obs_rms) == {"image", "observation"}
    assert float(ts.obs_rms["image"].count) > 1.0
    from airgym_tpu_torch.rl.runner import Runner
    _, trainer, _ = Runner().load(cfg).build({"task": "planning",
                                             "device": "cpu"})
    assert type(trainer) is tppo.PPO and trainer.frame_dedup
    back = tckpt.restore(trainer.init(9), tckpt.load(info["checkpoint"]))
    for k, v in ts.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[k], v), k
    assert torch.equal(back.obs_rms["image"].mean, ts.obs_rms["image"].mean)
    assert pathlib.Path(info["checkpoint"][:-3] + ".pth").exists()


def test_hazards_of_the_vision_path():
    """TF32 off for cuBLAS and cuDNN; the global-norm scale, not
    clip_grad_norm_, and it is active on the update tests' data; frames
    stored bf16 in the camera's [N, 1, W, H] layout with the per-step
    frame pointers h // cam_every; the image stats updated over the unique
    frames only."""
    import ast
    task = tenvs.make_task("planning", num_envs=N, device="cpu", **CAM)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    src = (REPO / "airgym_tpu_torch" / "rl" / "ppo.py").read_text()
    names = {n.attr for n in ast.walk(ast.parse(src))
             if isinstance(n, ast.Attribute)}
    assert "clip_grad_norm_" not in names and "randperm" not in names

    tr = tppo.PPO(task, tppo.PPOConfig(**SMALL))
    ts = tr.init(1)
    ts2, traj, _, _ = tr.rollout(ts)
    assert traj.frames.dtype == torch.bfloat16
    assert traj.frames.shape == (3, N, 1, W_, H_)
    assert traj.frame_idx.tolist() == [h // 4 for h in range(H)]
    assert torch.equal(traj.frames[-1], ts2.obs["image"].to(torch.bfloat16))
    assert "image" not in traj.obs
    ts3, _ = tr.train_epoch(ts)
    assert float(ts3.obs_rms["image"].count) == 1e-4 + 3 * N

    # the update tests' data drives the global norm past grad_norm
    jt, tt, ts_j, ts_t = vision_pair()
    d, frames = vision_dataset()
    dt = to_torch(d)
    img_u, idx = tt.unique_window(frames, dt["frame_idx"].long(), 0, 16)
    mb = {k: v[:16] for k, v in dt.items()
          if k not in ("obs", "frame_idx")}
    mb["obs"] = {"observation": dt["obs"]["observation"][:16],
                 "image_unique": img_u, "feat_index": idx}
    mb["mus"], mb["sigmas"] = mb["mus_init"], mb["sigmas_init"]
    loss, _ = tt._loss_fn(ts_t.model, ts_t.obs_rms, ts_t.value_rms, mb)
    grads = torch.autograd.grad(loss, list(ts_t.model.parameters()),
                                allow_unused=True)
    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads if g is not None))
    assert float(gnorm) > tt.cfg.grad_norm
