"""The port's stateful env facade (envs/base.TaskWrapper, envs.make_env)
and the vec-env glue on it (rl/vecenv.py) against the JAX package's: the
spaces and agent counts, the step / reset contract with MAPlanning's
flattened robot rows, and a wrapper step from a state carried over from
the JAX wrapper, obs / reward within atol 2e-5 (tests/test_torch_env.py's
tolerance)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import airgym_tpu.envs as jenvs
from airgym_tpu.rl import vecenv as jvecenv
import airgym_tpu_torch.envs as tenvs
from airgym_tpu_torch.envs.base import TaskWrapper
from airgym_tpu_torch.envs.hovering import HoveringState
from airgym_tpu_torch.rl import vecenv as tvecenv
from test_torch_env import to_port_core
from test_torch_maplanning import to_port_state

CAM = dict(cam_width=24, cam_height=20)


def test_vecenv_glue():
    """As tests/test_lib_components.py::test_vecenv_glue."""
    env = tvecenv.create_vec_env("hovering", 8, ctl_mode="rate",
                                 obs_noise=False, device="cpu")
    info = env.get_env_info()
    assert info["action_space"].shape == (4,)
    assert info["observation_space"].shape == (18,)
    assert info["agents"] == 1 and info["value_size"] == 1
    obs = env.reset()
    assert obs.shape == (8, 18)
    obs, rew, reset, extras = env.step(torch.zeros((8, 4)))
    assert set(extras) == {"time_outs", "item_reward_info"}
    assert rew.shape == reset.shape == (8,)
    assert env.get_env_state() is None


@pytest.mark.parametrize("name", ["hovering", "balloon", "tracking",
                                  "planning", "avoid", "maplanning",
                                  "customized"])
def test_env_info_matches_jax(name):
    """Spaces and agent counts of every trainable task, Dict spaces for
    the camera tasks; the registry holds every registered task."""
    kw = (dict(CAM) if name in ("planning", "avoid", "maplanning",
                                "customized") else {})
    j = jvecenv.create_vec_env(name, 2, **kw).get_env_info()
    t = tvecenv.create_vec_env(name, 2, device="cpu", **kw).get_env_info()
    assert t["agents"] == j["agents"] and t["value_size"] == j["value_size"]
    assert t["action_space"].shape == j["action_space"].shape
    np.testing.assert_array_equal(t["action_space"].low,
                                  j["action_space"].low)
    jo, to = j["observation_space"], t["observation_space"]
    if isinstance(jo, jvecenv.DictSpace):
        assert isinstance(to, tvecenv.DictSpace)
        for k in ("image", "observation"):
            assert to[k].shape == jo[k].shape, k
    else:
        assert to.shape == jo.shape
    assert set(tvecenv.configurations) == set(tenvs.registered_tasks())
    assert "customized" in tvecenv.configurations


def test_task_wrapper_contract_with_robot_rows():
    """MAPlanning through the facade: rows are envs x robots, step returns
    (obs, priv_obs, rew, reset, extras), reset re-draws from the wrapper's
    generator and takes a zero-action step."""
    env = tenvs.make_env("maplanning", seed=3, num_envs=2, obs_noise=False,
                         device="cpu", **CAM)
    assert isinstance(env, TaskWrapper)
    assert env.num_rows == 8 and env.num_envs == 2 and env.num_obs == 24
    obs, priv = env.reset()
    assert obs["observation"].shape == (8, 24)
    assert obs["image"].shape == (8, 1, 24, 20)
    obs, priv, rew, reset, extras = env.step(np.zeros((8, 4), np.float32))
    assert rew.shape == reset.shape == extras["time_outs"].shape == (8,)
    assert "env_success" in extras["item_reward_info"]
    torch.testing.assert_close(obs["observation"][:, 16:],
                               torch.zeros(8, 8))
    # the same seed draws the same first state; the wrapper's generator
    # moves on, so a reset draws another
    a = tenvs.make_env("maplanning", seed=3, num_envs=2, obs_noise=False,
                       device="cpu", **CAM)
    b = tenvs.make_env("maplanning", seed=3, num_envs=2, obs_noise=False,
                       device="cpu", **CAM)
    assert torch.equal(a.state.core.root, b.state.core.root)
    first = a.state.core.root.clone()
    a.reset()
    assert not torch.equal(a.state.core.root[:, :3], first[:, :3])
    vec = tvecenv.create_vec_env("maplanning", 2, obs_noise=False,
                                 device="cpu", **CAM)
    assert vec.get_number_of_agents() == 4


@pytest.mark.parametrize("name", ["hovering", "maplanning"])
def test_task_wrapper_step_matches_jax(name):
    """A wrapper step from the JAX wrapper's state, with the same
    actions: the same obs, reward, done and time-out flags."""
    kw = dict(CAM) if name == "maplanning" else {}
    jenv = jenvs.make_env(name, seed=0, num_envs=2, obs_noise=False, **kw)
    tenv = tenvs.make_env(name, seed=0, num_envs=2, obs_noise=False,
                          device="cpu", **kw)
    assert tenv.num_rows == jenv.num_rows
    js = jenv.state
    if name == "maplanning":
        js = js._replace(core=js.core._replace(
            reset_buf=jnp.zeros(jenv.num_rows, bool)))
        tenv.state = to_port_state(js)
    else:
        tenv.state = HoveringState(core=to_port_core(js.core))
    jenv.state = js
    act = np.random.default_rng(1).uniform(
        -0.3, 0.3, (jenv.num_rows, jenv.num_actions)).astype(np.float32)
    for _ in range(3):
        jo, _, jr, jd, je = jenv.step(jnp.asarray(act))
        to, _, tr, td, te = tenv.step(act)
    vec = (lambda o: o["observation"]) if name == "maplanning" else (
        lambda o: o)
    np.testing.assert_allclose(vec(to).numpy(), np.asarray(vec(jo)),
                               atol=2e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=2e-5)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(te["time_outs"].numpy(),
                                  np.asarray(je["time_outs"]))
