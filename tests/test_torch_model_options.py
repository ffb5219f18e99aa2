"""The port's actor-critic options beside the shipped net (models/
actor_critic.py): the six activations, the separate critic trunk and the
state-dependent sigma, against the JAX package's ActorCritic; the plain
trainer's loss and a whole train epoch with them; their .pth keys; the
refusal of a separate trunk with images.

Weights go JAX -> port with ``checkpoint.from_jax``; the JAX side runs at
matmul precision 'highest' (tests/conftest.py). Forward outputs within
rtol 1e-5 / atol 1e-5 (float32, other summation orders; a state-dependent
sigma is an exp of the head); the loss within rtol 1e-5 /
atol 1e-6, as tests/test_torch_ppo.py holds the default net's; the epoch:
params and moments within 2e-3 * max|ref| + 1e-5 per tensor, lr to rtol
1e-6, metrics to rtol 5e-3 / atol 5e-4 (tests/test_torch_ppo.py's)."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import airgym_tpu.envs as jenvs
import airgym_tpu_torch.envs as tenvs
from airgym_tpu.models import actor_critic as jac
from airgym_tpu.rl import checkpoint as jckpt
from airgym_tpu.rl import ppo as jppo
from airgym_tpu.rl import runner as jrunner
from airgym_tpu.rl.running_stats import RunningMeanStd as JaxRMS
from airgym_tpu_torch.envs.hovering import HoveringState
from airgym_tpu_torch.models import actor_critic as tac
from airgym_tpu_torch.rl import checkpoint as tckpt
from airgym_tpu_torch.rl import ppo as tppo
from airgym_tpu_torch.rl import runner as trunner
from airgym_tpu_torch.rl.running_stats import RunningMeanStd
from test_torch_env import to_port_core
from test_torch_ppo import close_tensors, jax_named, to_jax, to_torch

OBS, ACT = 18, 4
UNITS = (16, 32, 16)
ACTIVATIONS = ("elu", "relu", "tanh", "sigmoid", "sin", "none")
host = lambda tree: jax.tree.map(np.asarray, tree)


def perturbed(params, seed):
    """Every leaf moved off its init (the logstd head starts at zero, the
    heads at 0.1 scale): the options' paths all carry signal."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + rng.normal(
            0.0, 0.3, np.shape(a)).astype(np.float32)), params)


def net_pair(activation="elu", separate=False, fixed_sigma=True, seed=0):
    kw = dict(units=UNITS, activation=activation, separate=separate,
              fixed_sigma=fixed_sigma)
    jm = jac.ActorCritic(num_actions=ACT, **kw)
    params = perturbed(jm.init(jax.random.PRNGKey(seed),
                               jnp.zeros((1, OBS))), seed + 1)
    tm = tac.ActorCritic(OBS, ACT, **kw)
    tm.load_state_dict(tckpt.from_jax(host(params), None, None)["model"])
    return jm, params, tm


def vec_stats(seed=2):
    stat = np.random.default_rng(seed).normal(
        0.5, 2.0, (64, OBS)).astype(np.float32)
    return (JaxRMS.create((OBS,)).update(jnp.asarray(stat)),
            RunningMeanStd.create((OBS,)).update(torch.from_numpy(stat)))


@pytest.mark.parametrize("fixed_sigma", [True, False],
                         ids=["fixed", "state_sigma"])
@pytest.mark.parametrize("separate", [False, True],
                         ids=["shared", "separate"])
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_forward_matches_jax(activation, separate, fixed_sigma):
    jm, params, tm = net_pair(activation, separate, fixed_sigma)
    j_rms, t_rms = vec_stats()
    x = np.random.default_rng(3).normal(0, 2, (12, OBS)).astype(np.float32)
    mu_j, sig_j, v_j = jm.apply(params, jnp.asarray(x), j_rms)
    with torch.no_grad():
        mu_t, sig_t, v_t = tm(torch.from_numpy(x), t_rms)
    for got, ref in ((mu_t, mu_j), (sig_t, sig_j), (v_t, v_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    # the options take effect: a state-dependent sigma varies per sample,
    # and the separate value differs from the shared trunk's
    assert (np.ptp(np.asarray(sig_j), axis=0).max() > 1e-3) == (
        not fixed_sigma)
    assert hasattr(tm, "critic_mlp") == separate


def test_state_sigma_head_starts_at_one():
    """fixed_sigma: False starts with weight and bias zero: sigma is 1
    for every sample, as the JAX head's zero init gives."""
    tm = tac.ActorCritic(OBS, ACT, fixed_sigma=False,
                         generator=torch.Generator().manual_seed(0))
    x = torch.randn(8, OBS, generator=torch.Generator().manual_seed(1))
    _, sigma, _ = tm(x)
    assert torch.equal(sigma, torch.ones(8, ACT))
    assert set(dict(tm.named_parameters())) >= {"logstd.weight",
                                                "logstd.bias"}


def trainer_pair(n=16, network_kw=None, cfg_kw=None):
    small = dict(horizon=8, minibatch_size=32, mini_epochs=2,
                 **(cfg_kw or {}))
    nkw = dict(units=UNITS, separate=True, fixed_sigma=False,
               **(network_kw or {}))
    jt = jppo.PPO(jenvs.make_task("hovering", num_envs=n, obs_noise=False),
                  jppo.PPOConfig(**small), network_kw=nkw)
    tt = tppo.PPO(tenvs.make_task("hovering", num_envs=n, obs_noise=False,
                                  device="cpu"),
                  tppo.PPOConfig(**small), network_kw=nkw)
    ts_j = jt.init(jax.random.PRNGKey(0))
    ts_j = ts_j._replace(params=perturbed(ts_j.params, 5),
                         opt_state=jt.optimizer.init(ts_j.params))
    ck = tckpt.from_jax(host(ts_j.params), host(ts_j.obs_rms),
                        host(ts_j.value_rms),
                        adam_np=host(ts_j.opt_state[0]), lr=float(ts_j.lr))
    ts_t = tckpt.restore(tt.init(0), ck)
    return jt, tt, ts_j, ts_t


def test_loss_with_state_sigma_matches_jax():
    """The per-sample logstd through neglogp, entropy and the KL
    (JAX ppo.py:544-590), on a seeded dataset."""
    jt, tt, ts_j, ts_t = trainer_pair()
    rng = np.random.default_rng(9)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    b = 64
    mus = 0.3 * f(b, ACT)
    d = {"obs": 2.0 * f(b, OBS), "actions": mus + f(b, ACT),
         "neglogp": 5.0 + 0.1 * f(b), "values": f(b), "returns": f(b),
         "adv": f(b), "mus": mus,
         "sigmas": np.exp(0.2 * f(b, ACT)).astype(np.float32)}
    loss_j, aux_j = jt._loss_fn(ts_j.params, ts_j.obs_rms, ts_j.value_rms,
                                to_jax(d))
    loss_t, aux_t = tt._loss_fn(ts_t.model, ts_t.obs_rms, ts_t.value_rms,
                                to_torch(d))
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5, atol=1e-6)
    for k in ("a_loss", "c_loss", "b_loss", "entropy", "kl", "clip_frac"):
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(aux_t["sigma"].numpy(),
                               np.asarray(aux_j["sigma"]), rtol=1e-5)


def test_train_epoch_separate_state_sigma_matches_jax(monkeypatch):
    """One plain-trainer epoch at 16 envs with ``separate`` and
    ``fixed_sigma: False``: both sides act on the policy mean (their
    Gaussian draws come from different generators), from the same env
    state, so the rollouts, GAE, stats and update see the same data."""
    jt, tt, ts_j, ts_t = trainer_pair()
    ts_t = dataclasses.replace(
        ts_t, env_state=HoveringState(core=to_port_core(ts_j.env_state.core)),
        obs=torch.from_numpy(np.array(ts_j.obs)))

    def j_mean_policy(params, obs_rms, obs, key):
        mu, sigma, value, prenorm = jt.model.apply(params, obs, obs_rms,
                                                   return_prenorm=True)
        return (mu, jac.neglogp(mu, mu, sigma, jnp.log(sigma)), mu, sigma,
                value[..., 0], prenorm)

    def t_mean_policy(ts, obs, generator):
        mu, sigma, value, prenorm = ts.model(obs, tt._rms(ts),
                                             return_prenorm=True)
        return (mu, tac.neglogp(mu, mu, sigma, torch.log(sigma)), mu, sigma,
                value[..., 0], prenorm)

    monkeypatch.setattr(jt, "_policy", j_mean_policy)
    monkeypatch.setattr(tt, "_policy", t_mean_policy)
    ts_j2, m_j = jax.jit(jt.train_epoch)(ts_j)
    ts_t2, m_t = tt.train_epoch(ts_t)

    close_tensors(jax_named(ts_j2.params),
                  dict(ts_t2.model.named_parameters()))
    adam = ts_j2.opt_state[0]
    close_tensors(jax_named(adam.mu), ts_t2.adam["m"])
    close_tensors(jax_named(adam.nu), ts_t2.adam["v"])
    assert {"critic_mlp.layers.0.weight", "logstd.weight"} <= set(
        ts_t2.adam["m"])
    assert float(ts_t2.adam["count"][0]) == int(adam.count) == 2 * 4
    np.testing.assert_allclose(float(ts_t2.lr), float(ts_j2.lr), rtol=1e-6)
    for k in tppo.METRICS + ("mean_reward", "reward_raw_per_step",
                             "explained_variance"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=5e-3,
                                   atol=5e-4, err_msg=k)


NET_OPTIONS = {
    "default": {},
    "separate": {"separate": True},
    "state_sigma": {"fixed_sigma": False},
    "separate_state_sigma": {"separate": True, "fixed_sigma": False},
    "cnn": {"image_encoder": "cnn"},
    "vae": {"image_encoder": "vae", "vae_latent_dim": 8},
    "resnet": {"image_encoder": "resnet", "image_feature_dim": 12},
}


@pytest.mark.parametrize("option", sorted(NET_OPTIONS))
def test_pth_keys_match_jax_model_state_dict(option):
    """The .pth's model keys of every network option are those the JAX
    package's model_state_dict writes (no VAE / ResNet encoder keys)."""
    kw = NET_OPTIONS[option]
    enc = kw.get("image_encoder")
    jm = jac.ActorCritic(num_actions=ACT, **kw)
    sample = (jnp.zeros((1, OBS)) if enc is None else
              {"image": jnp.zeros((1, 1, 32, 16)),
               "observation": jnp.zeros((1, 16))})
    # the parameter tree's shapes alone (no init compile): only the keys
    # are compared
    params = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                          jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                         sample))
    feat = {"cnn": 30, "vae": 8, "resnet": 12}.get(enc, 0)
    n_obs = OBS if enc is None else 16
    if enc is None:
        j_rms, t_rms = vec_stats()
    else:
        j_rms = {"image": JaxRMS.create((1, 32, 16)),
                 "observation": JaxRMS.create((n_obs + feat,))}
        t_rms = {"image": RunningMeanStd.create((1, 32, 16)),
                 "observation": RunningMeanStd.create((n_obs + feat,))}
    want = set(jckpt.model_state_dict(params, j_rms, JaxRMS.create(())))
    tm = tac.ActorCritic(n_obs, ACT, **kw)
    got = set(tckpt.model_state_dict(tm, t_rms,
                                     RunningMeanStd.create(())))
    assert got == want


def test_pth_round_trip_of_the_options(tmp_path):
    """export_pth -> import_pth into a fresh model of the same options
    gives the same outputs; the JAX package's import_pth reads the file
    into the same outputs too."""
    jm, params, tm = net_pair("tanh", True, False, seed=4)
    j_rms, t_rms = vec_stats()
    ts = dataclasses.make_dataclass("TS", ["model", "obs_rms", "value_rms",
                                           "epoch", "frame"])(
        tm, t_rms, RunningMeanStd.create(()), 3, 96)
    path = str(tmp_path / "opts.pth")
    tckpt.export_pth(path, ts)
    tm2 = tac.ActorCritic(OBS, ACT, units=UNITS, activation="tanh",
                          separate=True, fixed_sigma=False)
    rms2, _, meta = tckpt.import_pth(path, tm2, RunningMeanStd.create((OBS,)),
                                     RunningMeanStd.create(()))
    x = torch.randn(6, OBS, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        for a, b in zip(tm(x, t_rms), tm2(x, rms2)):
            assert torch.equal(a, b)
    assert meta["epoch"] == 3
    p_j, rms_j, _, _ = jckpt.import_pth(path, params, j_rms,
                                        JaxRMS.create(()))
    mu_j, sig_j, v_j = jm.apply(p_j, jnp.asarray(x.numpy()), rms_j)
    with torch.no_grad():
        mu_t, sig_t, v_t = tm(x, t_rms)
    for got, ref in ((mu_t, mu_j), (sig_t, sig_j), (v_t, v_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("case", ["cnn_encoder", "dict_obs"])
def test_separate_with_images_raises(case):
    """As tests/test_runner.py::test_separate_vision_rejected: the
    reference's separate + vision branch is broken, so both frameworks
    refuse it, by the trainer's init or by a forward on a dict obs."""
    if case == "cnn_encoder":
        task = tenvs.make_task("planning", num_envs=4, num_trees=6,
                               cam_width=64, cam_height=32, device="cpu")
        trainer = tppo.PPO(task, tppo.PPOConfig(horizon=4, minibatch_size=8),
                           network_kw={"image_encoder": "cnn",
                                       "separate": True})
        with pytest.raises(ValueError, match="separate"):
            trainer.init(0)
    else:
        tm = tac.ActorCritic(16, ACT, separate=True)
        obs = {"observation": torch.zeros(2, 16),
               "features": torch.zeros(2, 0)}
        with pytest.raises(ValueError, match="separate"):
            tm(obs)


def test_network_kw_from_params_matches_jax():
    """The runner's reading of the network block, option for option."""
    blocks = [
        {"mlp": {"units": [32], "activation": "sin"}, "separate": True,
         "space": {"continuous": {"fixed_sigma": False}}},
        {"resnet": {"type": "resnet18", "output_dim": 12},
         "cnn": {"output_dim": 30}, "vae": {"latent_dims": 64}},
        {"cnn": {"output_dim": 24}, "vae": {"latent_dims": 64}},
        {"vae": {"latent_dims": 32}},
        {"space": {"continuous": {"fixed_sigma": True}}},
    ]
    for net in blocks:
        assert (trunner.network_kw_from_params({"network": net})
                == jrunner.network_kw_from_params({"network": net})), net
    for bad, err in (({"vae": {"return_sampled_latent": True}},
                      NotImplementedError),
                     ({"resnet": {"type": "resnet50"}}, ValueError)):
        for mod in (trunner, jrunner):
            with pytest.raises(err):
                mod.network_kw_from_params({"network": bad})


def test_runner_trains_and_plays_the_options(tmp_path):
    """As tests/test_runner.py::test_separate_and_nonfixed_sigma: a tanh,
    separate, state-sigma net trains 2 epochs with the plain trainer, the
    .pth carries critic_mlp.* and logstd.weight / .bias and no logstd,
    and --play of it runs."""
    cfg = {"params": {
        "seed": 3,
        "network": {"mlp": {"units": list(UNITS), "activation": "tanh"},
                    "separate": True,
                    "space": {"continuous": {"fixed_sigma": False}}},
        "config": {"name": "ppo_hovering", "num_actors": 16,
                   "horizon_length": 8, "minibatch_size": 32,
                   "mini_epochs": 2, "max_epochs": 2, "save_best_after": 1,
                   "use_fused_rollout": True}}}
    runner = trunner.Runner().load(cfg)
    args = {"task": "hovering", "num_envs": 16, "device": "cpu",
            "run_root": str(tmp_path)}
    _, trainer, _ = runner.build(args)
    assert type(trainer) is tppo.PPO
    ts, info = runner.run_train(args)
    assert info["epochs"] == 2 and all(
        math.isfinite(r["mean_reward"]) for r in info["history"])
    pth = info["checkpoint"][:-3] + ".pth"
    sd = torch.load(pth, map_location="cpu", weights_only=True)["model"]
    assert "critic_mlp.layers.0.weight" in sd
    assert {"logstd.weight", "logstd.bias"} <= set(sd) and "logstd" not in sd
    out = trunner.Runner().load(cfg).run(
        {"train": False, "task": "hovering", "num_envs": 8,
         "device": "cpu", "checkpoint": pth, "max_steps": 100, "seed": 0})
    assert math.isfinite(out["mean_reward"])
