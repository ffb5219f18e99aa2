"""PyTorch port vs the JAX reference: the Balloon and Tracking env steps.

Both sides start from the same state and take the same actions. The JAX
resets and obs noise draw from jax.random, whose bits PyTorch cannot
reproduce, so the step-by-step comparison runs with obs_noise off over a
window without resets; the reset draws are checked by their bounds."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import airgym_tpu.envs as jenvs
import airgym_tpu_torch.envs as tenvs
from airgym_tpu_torch.envs.balloon import BalloonState
from airgym_tpu_torch.envs.tracking import TrackingState
from airgym_tpu_torch.math import rotations as trot
from test_torch_env import assert_core_close, assert_out_close, to_port_core

N = 64


def make_pair(name):
    jt = jenvs.make_task(name, ctl_mode="rate", num_envs=N, obs_noise=False)
    tt = tenvs.make_task(name, ctl_mode="rate", num_envs=N, obs_noise=False,
                         device="cpu")
    return jt, tt


def actions(rng):
    return np.concatenate(
        [rng.uniform(-0.3, 0.3, (N, 3)),
         -0.69 + rng.uniform(-0.05, 0.05, (N, 1))], 1).astype(np.float32)


def test_balloon_steps_match_jax_without_resets():
    jt, tt = make_pair("balloon")
    js = jt.initial_state(jax.random.PRNGKey(0))
    root = np.array(js.core.root)
    root[:, 7] = np.abs(root[:, 7]) + 0.2        # flying forward: no kill
    js = js._replace(core=js.core._replace(root=jnp.asarray(root),
                                           reset_buf=jnp.zeros(N, bool)))
    ts = BalloonState(core=to_port_core(js.core),
                      balloon=torch.from_numpy(np.array(js.balloon)),
                      pre_root_pos=torch.from_numpy(np.array(js.pre_root_pos)))
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    jstep = jax.jit(jt.step)
    for _ in range(10):
        act = actions(rng)
        js, jo = jstep(js, jnp.asarray(act))
        ts, to = tt.step(ts, torch.from_numpy(act), gen)
        assert not bool(np.asarray(jo.reset).any()), "window must not reset"
        # the guidance term is 30x a difference of distances
        assert_out_close(jo, to, atol=1e-4)
        np.testing.assert_allclose(to.priv_obs.numpy(),
                                   np.asarray(jo.priv_obs), atol=1e-6)
        assert_core_close(js.core, ts.core)
        np.testing.assert_allclose(ts.pre_root_pos.numpy(),
                                   np.asarray(js.pre_root_pos), atol=2e-5)


def test_tracking_steps_match_jax_without_resets():
    jt, tt = make_pair("tracking")
    js = jt.initial_state(jax.random.PRNGKey(1))
    js = js._replace(core=js.core._replace(reset_buf=jnp.zeros(N, bool)))
    ts = TrackingState(core=to_port_core(js.core),
                       pre_root_pos=torch.from_numpy(np.array(js.pre_root_pos)))
    gen = torch.Generator().manual_seed(1)
    rng = np.random.default_rng(1)
    jstep = jax.jit(jt.step)
    for _ in range(20):
        act = actions(rng)
        js, jo = jstep(js, jnp.asarray(act))
        ts, to = tt.step(ts, torch.from_numpy(act), gen)
        assert not bool(np.asarray(jo.reset).any()), "window must not reset"
        assert to.obs.shape == (N, 48)
        assert_out_close(jo, to)
        assert_core_close(js.core, ts.core)
        np.testing.assert_allclose(ts.pre_root_pos.numpy(),
                                   np.asarray(js.pre_root_pos), atol=2e-5)
    prog = torch.from_numpy(np.array(js.core.progress))
    np.testing.assert_allclose(tt.ref_trajectory(prog).numpy(),
                               np.asarray(jt.ref_trajectory(js.core.progress)),
                               atol=1e-6)


@pytest.mark.parametrize("name", ["balloon", "tracking"])
def test_kills_and_timeouts_match_jax(name):
    """Envs at the episode's end time out; envs put out of bounds die;
    both sides agree on the flags and on the pre-reset obs and reward."""
    jt, tt = make_pair(name)
    js = jt.initial_state(jax.random.PRNGKey(2))
    core = js.core
    prog = np.array(core.progress)
    prog[:8] = jt.cfg.max_episode_length - 2
    root = np.array(core.root)
    root[:, 7] = np.abs(root[:, 7]) + 0.2
    if name == "tracking":                     # on track at the episode end
        ref = jt.ref_trajectory(jnp.asarray(prog + 1))
        root[:8, 0:3] = np.asarray(ref)[:8, 0]
    root[8:16, 0] += 4.0                       # past the balloon / off track
    core = core._replace(progress=jnp.asarray(prog), root=jnp.asarray(root),
                         reset_buf=jnp.zeros(N, bool))
    js = js._replace(core=core)
    pc = to_port_core(js.core)
    if name == "balloon":
        ts = BalloonState(core=pc, balloon=torch.from_numpy(
            np.array(js.balloon)), pre_root_pos=torch.from_numpy(
                np.array(js.pre_root_pos)))
    else:
        ts = TrackingState(core=pc, pre_root_pos=torch.from_numpy(
            np.array(js.pre_root_pos)))
    act = actions(np.random.default_rng(2))
    js2, jo = jax.jit(jt.step)(js, jnp.asarray(act))
    ts2, to = tt.step(ts, torch.from_numpy(act), torch.Generator())
    assert_out_close(jo, to, atol=1e-4)
    assert bool(to.timeout[:8].all()) and bool(to.reset[8:16].all())
    assert not bool(to.timeout[8:16].any())
    assert (ts2.core.progress[to.reset] == 0).all()
    assert float(ts2.pre_root_pos[to.reset].abs().max()) == 0.0
    keep = ~to.reset
    np.testing.assert_allclose(ts2.core.root[keep].numpy(),
                               np.asarray(js2.core.root)[keep.numpy()],
                               atol=2e-5)


def test_reset_draws_bounds():
    b = tenvs.make_task("balloon", num_envs=4096, device="cpu")
    g = torch.Generator().manual_seed(3)
    root = b._reset_root(g, 4096)
    ball = b._reset_balloon(g, 4096)
    assert float(root[:, 0:2].abs().max()) <= 0.1
    assert float((root[:, 2] - 1.0).abs().max()) <= 0.2
    e = trot.quat_to_euler_xyz(root[:, 3:7])
    assert float(e[:, 1].min()) >= -1e-5                 # one-sided pitch
    assert float(e[:, 1].max()) <= 0.1 * math.pi + 1e-5
    assert float(e[:, 2].abs().max()) <= 0.2 * math.pi + 1e-5
    assert float((ball[:, 0] - 2.5).abs().max()) <= 0.5
    assert float(ball[:, 1].abs().max()) <= 2.0
    assert float((ball[:, 2] - 1.0).abs().max()) <= 0.3
    assert torch.equal(ball[:, 6], torch.ones(4096))
    t = tenvs.make_task("tracking", num_envs=4096, device="cpu")
    root = t._reset_root(torch.Generator().manual_seed(4), 4096)
    assert float(root[:, 0:2].abs().max()) <= 0.1
    assert float((root[:, 2] - 1.0).abs().max()) <= 0.1
    assert float(root[:, 7:10].abs().max()) <= 0.5
    assert float(root[:, 10:13].abs().max()) <= 0.2


def test_action_limits_per_task():
    big = torch.full((1, 4), 3.0)
    b = tenvs.make_task("balloon", num_envs=1, device="cpu")
    t = tenvs.make_task("tracking", num_envs=1, device="cpu")
    assert b.remap_actions(big).tolist() == [[1.0, 1.0, 1.0, 1.0]]
    assert t.remap_actions(big).tolist() == [[3.0, 3.0, 3.0, 1.0]]
    assert b.has_success and not t.has_success
    assert (b.num_obs, t.num_obs) == (18, 48)
    assert tenvs.registered_tasks() == ["avoid", "balloon", "customized",
                                        "depthgen", "hovering", "maplanning",
                                        "planning", "tracking"]
