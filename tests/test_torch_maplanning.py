"""PyTorch port vs the JAX reference: the MAPlanning task, at 4 and at 2
robots per env.

Both sides start from the same state (the JAX one carried over) and take
the same actions. Steps with ``render=False`` keep the camera image and
are compared in full over a window without env resets (the reset draws
come from different generators); the env-level events are checked on the
step that ends them. A ``render=True`` step holds the port's clean image
(the raw depth kernel's plain version, clamped and normalised) against
the JAX package's ``render_depth_pallas`` in interpret mode, clamped and
normalised the same way, at the tolerance of
tests/test_torch_render_depth.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import airgym_tpu.envs as jenvs
import airgym_tpu_torch.envs as tenvs
from airgym_tpu.physics import scene as jsc
from airgym_tpu.render import depth as jdr
from airgym_tpu.render import pallas_raycast as jpr
from airgym_tpu_torch.envs.maplanning import MAPlanningState
from test_torch_env import assert_core_close, to_port_core
from test_torch_render_depth import assert_depth_close

E = 3
CAM = dict(cam_width=32, cam_height=16)


def make_pair(r):
    jt = jenvs.make_task("maplanning", num_envs=E, num_robots=r, **CAM)
    tt = tenvs.make_task("maplanning", num_envs=E, num_robots=r,
                         device="cpu", **CAM)
    return jt, tt


def to_port_state(js) -> MAPlanningState:
    t = lambda a: torch.from_numpy(np.array(a))
    return MAPlanningState(core=to_port_core(js.core), goal=t(js.goal),
                           camera=t(js.camera), esdf=t(js.esdf),
                           counter=int(js.counter),
                           pre_root_pos=t(js.pre_root_pos))


def start(r, seed=0):
    """A fresh JAX state with the robots flying (no zero-thrust first
    step) and a non-trivial camera image; both sides at it."""
    jt, tt = make_pair(r)
    js = jt.initial_state(jax.random.PRNGKey(seed))
    cam = np.random.default_rng(seed).uniform(
        0.2, 1.0, js.camera.shape).astype(np.float32)
    js = js._replace(core=js.core._replace(
        reset_buf=jnp.zeros(E * r, bool)), camera=jnp.asarray(cam))
    return jt, tt, js, to_port_state(js)


def actions(rng, n):
    return np.concatenate(
        [rng.uniform(-0.2, 0.2, (n, 3)),
         -0.69 + rng.uniform(-0.05, 0.05, (n, 1))], 1).astype(np.float32)


def assert_out_close(jo, to, atol=2e-5):
    np.testing.assert_allclose(to.obs["observation"].numpy(),
                               np.asarray(jo.obs["observation"]), atol=atol)
    np.testing.assert_allclose(to.reward.numpy(), np.asarray(jo.reward),
                               atol=atol)
    np.testing.assert_array_equal(to.reset.numpy(), np.asarray(jo.reset))
    np.testing.assert_array_equal(to.timeout.numpy(), np.asarray(jo.timeout))
    assert set(to.info) == set(jo.info)
    for k, v in jo.info.items():
        np.testing.assert_allclose(to.info[k].numpy(), np.asarray(v),
                                   atol=atol, err_msg=k)
    # the goal ball's root state: a reset env has a newly drawn goal
    kept = ~np.asarray(jo.info["env_done"]).reshape(E, -1)[:, 0]
    assert to.priv_obs.shape == (E, 1, 13)
    np.testing.assert_allclose(to.priv_obs.numpy()[kept],
                               np.asarray(jo.priv_obs)[kept], atol=1e-6)


@pytest.mark.parametrize("r", [4, 2])
def test_steps_without_render_match_jax(r):
    jt, tt, js, ts = start(r, seed=r)
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(r)
    jstep = jax.jit(jt.step, static_argnames=("render",))
    for _ in range(6):
        act = actions(rng, E * r)
        js, jo = jstep(js, jnp.asarray(act), render=False)
        ts, to = tt.step(ts, torch.from_numpy(act), gen, render=False)
        assert not bool(np.asarray(jo.info["env_done"]).any()), \
            "window must not reset"
        assert_out_close(jo, to)
        assert to.obs["observation"].shape == (E * r, 16 + 2 * r)
        assert float(to.obs["observation"][:, 16:].abs().max()) == 0.0
        np.testing.assert_array_equal(to.obs["image"].numpy(),
                                      np.asarray(jo.obs["image"]))
        assert_core_close(js.core, ts.core)
        np.testing.assert_allclose(ts.esdf.numpy(), np.asarray(js.esdf))
        np.testing.assert_allclose(ts.pre_root_pos.numpy(),
                                   np.asarray(js.pre_root_pos), atol=2e-5)
        np.testing.assert_array_equal(ts.goal.numpy(), np.asarray(js.goal))
        assert ts.counter == int(js.counter)
    assert tt.flat_n == tt.num_actors_flat == E * r
    assert tt.cfg.num_agents == r and tt.has_env_success and tt.has_success
    assert ts.core.progress.shape == (E,)


def jax_clean_image(jt, root, goal):
    """The JAX task's scene (maplanning.py:157-178) through the Pallas raw
    depth kernel in interpret mode, clamped and normalised."""
    e, r = jt.cfg.num_envs, jt.cfg.num_robots
    n = e * r
    pos = root[:, 0:3].reshape(e, r, 3)
    centers = jnp.concatenate([
        jnp.broadcast_to(pos[:, None], (e, r, r, 3)).reshape(n, r, 3),
        jnp.broadcast_to(goal[:, None, None], (e, r, 1, 3)).reshape(n, 1, 3)],
        axis=1)
    scene = jdr.SceneForRender(
        spheres=jsc.Spheres(center=centers, radius=jnp.full((n, r + 1), 0.2),
                            valid=jnp.ones((n, r + 1), bool)), ground=True)
    depth = jpr.render_depth_pallas(jt.cam_cfg, root, scene, interpret=True)
    return np.asarray(jnp.clip(depth, 0.0, 4.5) / 4.5)[:, None]


@pytest.mark.parametrize("r", [4, 2])
def test_render_step_matches_pallas_clean_image(r):
    """render=True: the camera after the step is the clean image of the
    post-physics roots; each robot sees its own env's robots and goal.
    The robots fly side by side toward the goal, so they see each other."""
    jt, tt, js, ts = start(r, seed=10 + r)
    root = np.array(js.core.root)
    er = root.reshape(E, r, 13)
    er[:, :, 0] = np.linspace(-8.5, -7.0, r)[None]     # staggered in x
    er[:, :, 1] = np.linspace(-0.6, 0.6, r)[None]
    js = js._replace(core=js.core._replace(root=jnp.asarray(root)))
    ts = to_port_state(js)
    act = actions(np.random.default_rng(r), E * r)
    js2, _ = jax.jit(jt.step, static_argnames=("render",))(
        js, jnp.asarray(act), render=False)
    ts2, to = tt.step(ts, torch.from_numpy(act), torch.Generator(),
                      render=True)
    want = jax_clean_image(jt, js2.core.root, js.goal)
    got = to.obs["image"].numpy()
    assert got.shape == (E * r, 1, 32, 16)
    assert got.max() <= 1.0 and got.min() >= 0.0
    assert (got < 0.9).sum() > 10                      # robots in view
    assert_depth_close(got, want)
    np.testing.assert_allclose(ts2.esdf.numpy(), want.reshape(E * r, -1).min(-1),
                               rtol=1e-3)


def test_any_robot_resets_env_and_env_events_match_jax():
    """Robot 0 of env 0 flies above the ceiling (env 0 resets, its other
    robots report no done of their own), robot 1 of env 1 reaches the goal
    (env success on every row of env 1, per-robot success on robot 1
    only), env 2 times out; outputs match, and the reset envs restart at
    the corridor's start with a new goal."""
    r = 4
    jt, tt, js, ts = start(r, seed=5)
    root = np.array(js.core.root)
    root[0, 2] = 1.85
    goal = np.array(js.goal)
    root[r + 1, 0:3] = goal[1] - np.array([0.1, 0.0, 0.0])
    prog = np.array(js.core.progress)
    prog[2] = jt.cfg.max_episode_length - 2
    js = js._replace(core=js.core._replace(root=jnp.asarray(root),
                                           progress=jnp.asarray(prog)))
    ts = to_port_state(js)
    act = actions(np.random.default_rng(5), E * r)
    js2, jo = jax.jit(jt.step, static_argnames=("render",))(
        js, jnp.asarray(act), render=False)
    ts2, to = tt.step(ts, torch.from_numpy(act), torch.Generator(),
                      render=False)
    assert_out_close(jo, to)
    reset = to.reset.reshape(E, r).numpy()
    assert reset[0].tolist() == [True, False, False, False]
    assert reset[1].tolist() == [False, True, False, False]
    assert not reset[2].any()
    assert to.timeout.reshape(E, r).numpy().tolist() == [[False] * r] * 2 + [
        [True] * r]
    assert to.info["env_done"].all()
    assert to.info["env_success"].reshape(E, r).numpy().tolist() == [
        [False] * r, [True] * r, [False] * r]
    assert to.info["success"].sum() == 1 and bool(to.info["success"][r + 1])
    assert float(to.info["reach_goal_reward"][r + 1]) == 200.0
    # every env reset: the robots restart at the corridor's start
    new = ts2.core.root.reshape(E, r, 13)
    np.testing.assert_allclose(new[..., 0].numpy(), -8.5)
    np.testing.assert_allclose(new[..., 2].numpy(), 1.5)
    assert float(new[..., 1].abs().max()) <= 2.0
    assert (ts2.core.progress == 0).all() and bool(ts2.core.reset_buf.all())
    assert float(ts2.core.pre_actions.abs().max()) == 0.0
    np.testing.assert_allclose(ts2.goal[:, 0].numpy(), 8.5)


def test_env_reset_keeps_the_other_envs():
    """Only the env of the robot that is done resets; the flat rows are
    env-major (repeat_interleave, not repeat)."""
    r = 2
    jt, tt, js, ts = start(r, seed=6)
    root = np.array(js.core.root)
    root[2 * r + 1, 2] = 0.1                           # env 2 robot 1: ground
    js = js._replace(core=js.core._replace(root=jnp.asarray(root)))
    ts = to_port_state(js)
    act = actions(np.random.default_rng(6), E * r)
    js2, jo = jax.jit(jt.step, static_argnames=("render",))(
        js, jnp.asarray(act), render=False)
    ts2, to = tt.step(ts, torch.from_numpy(act), torch.Generator(),
                      render=False)
    assert_out_close(jo, to)
    done = to.info["env_done"].numpy()
    assert done.tolist() == [False] * (2 * r) + [True] * r
    keep = ~done
    np.testing.assert_allclose(ts2.core.root[keep].numpy(),
                               np.asarray(js2.core.root)[keep], atol=2e-5)
    np.testing.assert_array_equal(ts2.goal[:2].numpy(),
                                  np.asarray(js2.goal)[:2])
    assert ts2.core.progress.tolist() == [1, 1, 0]


def test_initial_state_draw_ranges():
    tt = tenvs.make_task("maplanning", num_envs=256, device="cpu", **CAM)
    st = tt.initial_state(torch.Generator().manual_seed(4))
    n = 256 * 4
    assert st.core.root.shape == (n, 13) and st.core.progress.shape == (256,)
    assert st.core.pre_actions.shape == (n, 4) and st.camera.shape == (
        n, 1, 32, 16)
    np.testing.assert_allclose(st.goal[:, 0].numpy(), 8.5)
    np.testing.assert_allclose(st.goal[:, 2].numpy(), 1.5)
    assert float(st.goal[:, 1].abs().max()) <= 1.5
    assert float(st.goal[:, 1].std()) > 0.5
    y = st.core.root[:, 1]
    assert float(y.abs().max()) <= 2.0 and float(y.std()) > 0.9
    np.testing.assert_allclose(st.core.root[:, 0].numpy(), -8.5)
    np.testing.assert_allclose(st.core.root[:, 2].numpy(), 1.5)
    # every robot faces its env's goal
    from airgym_tpu_torch.envs.avoid import yaw_deroll_matrix
    g = torch.repeat_interleave(st.goal, 4, dim=0) - st.core.root[:, 0:3]
    w2l, _ = yaw_deroll_matrix(st.core.root[:, 3:7])
    local = torch.einsum("nij,nj->ni", w2l, g)
    np.testing.assert_allclose((local[:, 0] / local.norm(dim=-1)).numpy(),
                               1.0, atol=1e-5)
    assert bool(st.core.reset_buf.all()) and st.counter == 0
    np.testing.assert_allclose(st.esdf.numpy(), 10.0)
    st2 = tenvs.make_task("maplanning", num_envs=2, start_x=-2.0,
                          device="cpu", **CAM).initial_state(
        torch.Generator().manual_seed(1))
    np.testing.assert_allclose(st2.core.root[:, 0].numpy(), -2.0)
