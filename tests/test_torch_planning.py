"""PyTorch port vs the JAX reference: the Planning env.

Both sides start from the same state (the JAX one carried over) and take
the same actions. Steps with ``render=False`` keep the same camera image
on both sides and are compared in full; the scene-reset draws come from
different generators, so the comparison runs over a window without
resets, and kills, time-outs and goal reaches are checked on the step
that ends them. Steps with ``render=True`` hold the port's camera (the
fused pipeline's plain version, culled) against the JAX hash mirror
``postprocess_hash(render_depth(...))`` with the port's camera seed, at
the 1e-5 of tests/test_fused_render.py."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import airgym_tpu.envs as jenvs
import airgym_tpu_torch.envs as tenvs
from airgym_tpu import assets as jassets
from airgym_tpu.envs.avoid import local_state_obs as j_local_obs
from airgym_tpu.envs.avoid import yaw_deroll_matrix as j_deroll
from airgym_tpu.render import depth as jdr
from airgym_tpu.render import pallas_raycast as jpr
from airgym_tpu_torch import assets as tassets
from airgym_tpu_torch.envs.avoid import local_state_obs as t_local_obs
from airgym_tpu_torch.envs.avoid import yaw_deroll_matrix as t_deroll
from airgym_tpu_torch.envs.planning import PlanningState
from test_torch_env import assert_core_close, to_port_core

N = 16
CAM = dict(cam_width=32, cam_height=16)


def make_pair():
    jt = jenvs.make_task("planning", ctl_mode="rate", num_envs=N, **CAM)
    tt = tenvs.make_task("planning", ctl_mode="rate", num_envs=N,
                         device="cpu", **CAM)
    return jt, tt


def to_port_state(js) -> PlanningState:
    t = lambda a: torch.from_numpy(np.array(a))
    return PlanningState(
        core=to_port_core(js.core), goal=t(js.goal),
        tree_variant=t(js.tree_variant).long(), tree_pos=t(js.tree_pos),
        tree_yaw=t(js.tree_yaw), camera=t(js.camera), esdf=t(js.esdf),
        counter=int(js.counter), pre_root_pos=t(js.pre_root_pos))


def start(seed=0):
    """Both sides at a fresh JAX state half a metre into the corridor,
    the drones already flying (no zero-thrust first step) and a
    non-trivial camera image."""
    jt, tt = make_pair()
    js = jt.initial_state(jax.random.PRNGKey(seed))
    cam = np.random.default_rng(seed).uniform(
        0.2, 3.0, js.camera.shape).astype(np.float32)
    root = np.array(js.core.root)
    root[:, 0] += 0.5        # off the corridor's back edge (x < -8.5 dies)
    js = js._replace(core=js.core._replace(reset_buf=jnp.zeros(N, bool),
                                           root=jnp.asarray(root)),
                     camera=jnp.asarray(cam))
    return jt, tt, js, to_port_state(js)


def actions(rng):
    return np.concatenate(
        [rng.uniform(-0.2, 0.2, (N, 3)),
         -0.69 + rng.uniform(-0.05, 0.05, (N, 1))], 1).astype(np.float32)


def assert_out_close(jo, to, atol=2e-5):
    np.testing.assert_allclose(to.obs["observation"].numpy(),
                               np.asarray(jo.obs["observation"]), atol=atol)
    np.testing.assert_allclose(to.reward.numpy(), np.asarray(jo.reward),
                               atol=atol)
    np.testing.assert_array_equal(to.reset.numpy(), np.asarray(jo.reset))
    np.testing.assert_array_equal(to.timeout.numpy(), np.asarray(jo.timeout))
    for k, v in jo.info.items():
        np.testing.assert_allclose(to.info[k].numpy(), np.asarray(v),
                                   atol=atol, err_msg=k)


def test_local_state_helpers_match_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(32, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    jw, jm = j_deroll(jnp.asarray(q))
    tw, tm = t_deroll(torch.from_numpy(q))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6)
    root = rng.normal(size=(32, 13)).astype(np.float32)
    root[:, 3:7] = q
    act = rng.normal(size=(32, 4)).astype(np.float32)
    np.testing.assert_allclose(
        t_local_obs(torch.from_numpy(root), (0.0, 0.0, 1.0),
                    torch.from_numpy(act)).numpy(),
        np.asarray(j_local_obs(jnp.asarray(root), (0.0, 0.0, 1.0),
                               jnp.asarray(act))), atol=1e-5)


def test_tree_cylinders_match_jax():
    rng = np.random.default_rng(1)
    var = rng.integers(0, 100, (4, 40))
    pos = rng.uniform(-8, 8, (4, 40, 2)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, (4, 40)).astype(np.float32)
    np.testing.assert_array_equal(tassets.thin_tree_table(),
                                  jassets.thin_tree_table())
    jc = jassets.tree_cylinders_from_placement(jnp.asarray(var),
                                               jnp.asarray(pos),
                                               jnp.asarray(yaw))
    tc = tassets.tree_cylinders_from_placement(torch.from_numpy(var),
                                               torch.from_numpy(pos),
                                               torch.from_numpy(yaw))
    for f in ("center", "axis", "half_len", "radius", "valid"):
        np.testing.assert_allclose(getattr(tc, f).numpy(),
                                   np.asarray(getattr(jc, f)), atol=1e-6,
                                   err_msg=f)


def test_steps_without_render_match_jax():
    jt, tt, js, ts = start(0)
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    jstep = jax.jit(jt.step, static_argnames=("render",))
    for _ in range(8):
        act = actions(rng)
        js, jo = jstep(js, jnp.asarray(act), render=False)
        ts, to = tt.step(ts, torch.from_numpy(act), gen, render=False)
        assert not bool(np.asarray(jo.reset).any()), "window must not reset"
        assert_out_close(jo, to)
        np.testing.assert_array_equal(to.obs["image"].numpy(),
                                      np.asarray(jo.obs["image"]))
        np.testing.assert_allclose(to.priv_obs.numpy(),
                                   np.asarray(jo.priv_obs), atol=1e-6)
        assert_core_close(js.core, ts.core)
        np.testing.assert_allclose(ts.esdf.numpy(), np.asarray(js.esdf))
        np.testing.assert_allclose(ts.pre_root_pos.numpy(),
                                   np.asarray(js.pre_root_pos), atol=2e-5)
        assert ts.counter == int(js.counter)
    assert tt.obs_is_dict and tt.has_success and tt.cam_every == 4


def test_render_steps_match_hash_pipeline():
    """render=True: the camera after the step is the fused pipeline
    (culled: 41 records > 16) on the post-physics root, with the seed the
    step drew first from the generator."""
    jt, tt, js, ts = start(1)
    gen = torch.Generator().manual_seed(1)
    rng = np.random.default_rng(1)
    jstep = jax.jit(jt.step, static_argnames=("render",))
    for _ in range(2):
        act = actions(rng)
        probe = torch.Generator()
        probe.set_state(gen.get_state())
        seed = int(torch.randint(0, 2 ** 32, (), generator=probe,
                                 dtype=torch.int64))
        scene = jdr.SceneForRender(
            cylinders=jt._cylinders(js), spheres=jt._goal_spheres(js.goal),
            ground=True)
        js, jo = jstep(js, jnp.asarray(act), render=False)
        ts, to = tt.step(ts, torch.from_numpy(act), gen, render=True)
        key = jnp.asarray([seed, 0], jnp.uint32)
        want = np.asarray(jpr.postprocess_hash(
            jt.cam_cfg, jdr.render_depth(jt.cam_cfg, js.core.root, scene),
            key))
        got = to.obs["image"].numpy()
        assert got.shape == (N, 1, 32, 16) and want.max() > 0.0
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ts.esdf.numpy(),
                                   want.reshape(N, -1).min(-1), rtol=1e-5,
                                   atol=1e-5)
        assert_core_close(js.core, ts.core)


def test_kills_goal_and_timeouts_match_jax():
    """Envs at the episode's end time out, out-of-bounds envs die, envs at
    the goal ball succeed with +200; flags, rewards and pre-reset obs
    agree, and the reset envs restart at the corridor's start."""
    jt, tt, js, ts = start(2)
    core = js.core
    prog = np.array(core.progress)
    prog[:4] = jt.cfg.max_episode_length - 2
    root = np.array(core.root)
    root[4:8, 1] = 4.5                                  # out of bounds
    goal = np.array(js.goal)
    root[8:12, 0:3] = goal[8:12] - np.array([0.1, 0.0, 0.0])   # at the goal
    js = js._replace(core=core._replace(progress=jnp.asarray(prog),
                                        root=jnp.asarray(root)))
    ts = to_port_state(js)
    act = actions(np.random.default_rng(2))
    js2, jo = jax.jit(jt.step, static_argnames=("render",))(
        js, jnp.asarray(act), render=False)
    ts2, to = tt.step(ts, torch.from_numpy(act), torch.Generator(),
                      render=False)
    assert_out_close(jo, to)
    assert bool(to.timeout[:4].all()) and bool(to.reset[4:12].all())
    assert bool(to.info["success"][8:12].all())
    assert float(to.info["reach_goal_reward"][8:12].min()) == 200.0
    keep = ~to.reset
    np.testing.assert_allclose(ts2.core.root[keep].numpy(),
                               np.asarray(js2.core.root)[keep.numpy()],
                               atol=2e-5)
    r = ts2.core.root[to.reset]
    np.testing.assert_allclose(r[:, 0:3].numpy(),
                               np.tile([-8.5, 0.0, 1.5], (len(r), 1)),
                               atol=1e-6)
    assert (ts2.core.progress[to.reset] == 0).all()


def test_initial_state_and_reset_draws():
    tt = tenvs.make_task("planning", num_envs=512, device="cpu", **CAM)
    st = tt.initial_state(torch.Generator().manual_seed(4))
    assert st.tree_variant.min() >= 0 and st.tree_variant.max() < 100
    assert float(st.tree_pos[..., 0].abs().max()) <= 8.0
    assert float(st.tree_pos[..., 1].abs().max()) <= 4.0
    assert float(st.tree_yaw.abs().max()) <= np.pi
    assert float(st.goal[:, 1].abs().max()) <= 1.5
    np.testing.assert_allclose(st.goal[:, 0].numpy(), 8.5)
    # the drone faces the goal: heading = goal direction's local x
    g_dir = st.goal - st.core.root[:, 0:3]
    w2l, _ = t_deroll(st.core.root[:, 3:7])
    local = torch.einsum("nij,nj->ni", w2l, g_dir)
    np.testing.assert_allclose((local[:, 0] / local.norm(dim=-1)).numpy(),
                               1.0, atol=1e-5)
    assert st.camera.shape == (512, 1, 32, 16) and st.counter == 0
