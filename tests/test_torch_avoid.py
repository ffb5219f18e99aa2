"""PyTorch port vs the JAX reference: the Avoid task and the ballistic
step of its thrown cube.

Both sides start from the same state (the JAX one carried over) and take
the same actions. Steps with ``render=False`` are compared in full over
a window without resets (the reset draws come from different
generators); kills, collisions and successes are checked on the step
that ends them. A ``render=True`` step holds the port's camera (the
fused render + post-process pipeline's plain version) against the JAX
hash mirror ``postprocess_hash(render_depth(...))`` with the port's
camera seed, at the 1e-5 of tests/test_fused_render.py."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import airgym_tpu.envs as jenvs
import airgym_tpu_torch.envs as tenvs
from airgym_tpu.physics import quadrotor as jqd
from airgym_tpu.render import depth as jdr
from airgym_tpu.render import pallas_raycast as jpr
from airgym_tpu_torch.envs.avoid import AvoidState
from airgym_tpu_torch.physics import quadrotor as tqd
from test_torch_env import assert_core_close, to_port_core
from test_torch_planning import assert_out_close

N = 16
CAM = dict(cam_width=32, cam_height=16)


def make_pair():
    jt = jenvs.make_task("avoid", num_envs=N, **CAM)
    tt = tenvs.make_task("avoid", num_envs=N, device="cpu", **CAM)
    return jt, tt


def to_port_state(js) -> AvoidState:
    t = lambda a: torch.from_numpy(np.array(a))
    return AvoidState(core=to_port_core(js.core), obj=t(js.obj),
                      camera=t(js.camera), counter=int(js.counter),
                      pre_root_pos=t(js.pre_root_pos))


def start(seed=0):
    """A fresh JAX state with the drones flying (no zero-thrust first
    step), every cube in flight, and a non-trivial camera image."""
    jt, tt = make_pair()
    js = jt.initial_state(jax.random.PRNGKey(seed))
    obj = np.array(js.obj)
    parked = obj[:, 0] < -900
    obj[parked] = np.array(js.obj)[~parked][0]
    cam = np.random.default_rng(seed).uniform(
        0.0, 3.0, js.camera.shape).astype(np.float32)
    js = js._replace(core=js.core._replace(reset_buf=jnp.zeros(N, bool)),
                     obj=jnp.asarray(obj), camera=jnp.asarray(cam))
    return jt, tt, js, to_port_state(js)


def actions(rng):
    return np.concatenate(
        [rng.uniform(-0.2, 0.2, (N, 3)),
         -0.69 + rng.uniform(-0.05, 0.05, (N, 1))], 1).astype(np.float32)


def test_ballistic_step_matches_jax():
    s = np.random.default_rng(0).normal(size=(2, 5, 13)).astype(np.float32)
    want = np.asarray(jqd.ballistic_step(0.01, 9.81, jnp.asarray(s)))
    got = tqd.ballistic_step(0.01, 9.81, torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(got[..., 3:7], s[..., 3:7])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_steps_without_render_match_jax():
    """The cubes fly toward the drones; one lands on the ground on the
    way (its rest height is z 0.5)."""
    jt, tt, js, ts = start(0)
    obj = np.array(js.obj)
    obj[3, 2], obj[3, 9] = 0.52, -1.0                   # about to land
    js = js._replace(obj=jnp.asarray(obj))
    ts = to_port_state(js)
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    jstep = jax.jit(jt.step, static_argnames=("render",))
    for _ in range(6):
        act = actions(rng)
        js, jo = jstep(js, jnp.asarray(act), render=False)
        ts, to = tt.step(ts, torch.from_numpy(act), gen, render=False)
        assert not bool(np.asarray(jo.reset).any()), "window must not reset"
        assert_out_close(jo, to)
        np.testing.assert_allclose(to.priv_obs.numpy(),
                                   np.asarray(jo.priv_obs), atol=2e-5)
        np.testing.assert_array_equal(to.obs["image"].numpy(),
                                      np.asarray(jo.obs["image"]))
        assert_core_close(js.core, ts.core)
        np.testing.assert_allclose(ts.obj.numpy(), np.asarray(js.obj),
                                   atol=2e-5)
        assert ts.counter == int(js.counter)
    assert float(ts.obj[3, 2]) == 0.5 and float(ts.obj[3, 7:10].abs().max()) == 0
    assert to.priv_obs.shape == (N, 1, 13)
    assert tt.obs_is_dict and tt.has_success and tt.cfg.cam_every == 4


def test_kills_collisions_and_success_match_jax():
    """A cube inside the body sphere (collision, alive -500), a drone on
    the ground (collision), one out of the kill box, one upside down, and
    envs at the time-out (success); outputs match, and only the reset
    envs are re-drawn."""
    jt, tt, js, ts = start(2)
    root = np.array(js.core.root)
    obj = np.array(js.obj)
    obj[0:2, 0:3] = root[0:2, 0:3] + np.array([0.2, 0.0, 0.0])
    obj[0:2, 7:10] = 0.0
    root[2, 2] = 0.15                                   # on the ground
    root[3, 0] = 2.5                                    # out of the box
    root[4, 3:7] = np.array([1.0, 0.0, 0.0, 0.0])        # upside down
    prog = np.array(js.core.progress)
    prog[5:8] = jt.cfg.max_episode_length - 2
    js = js._replace(core=js.core._replace(root=jnp.asarray(root),
                                           progress=jnp.asarray(prog)),
                     obj=jnp.asarray(obj))
    ts = to_port_state(js)
    act = actions(np.random.default_rng(2))
    js2, jo = jax.jit(jt.step, static_argnames=("render",))(
        js, jnp.asarray(act), render=False)
    ts2, to = tt.step(ts, torch.from_numpy(act), torch.Generator(),
                      render=False)
    assert_out_close(jo, to)
    assert bool(to.reset[0:8].all()) and not bool(to.reset[8:].any())
    assert to.info["alive_reward"][0:3].tolist() == [-500.0] * 3
    assert to.info["success"].tolist() == [False] * 5 + [True] * 3 + [
        False] * (N - 8)
    keep = ~to.reset
    np.testing.assert_allclose(ts2.core.root[keep].numpy(),
                               np.asarray(js2.core.root)[keep.numpy()],
                               atol=2e-5)
    np.testing.assert_allclose(ts2.obj[keep].numpy(),
                               np.asarray(js2.obj)[keep.numpy()], atol=2e-5)
    assert (ts2.core.progress[~keep] == 0).all()
    # the reset drones restart near (0, 0, 1)
    r = ts2.core.root[~keep]
    assert float(r[:, 0:2].abs().max()) <= 0.2
    assert float((r[:, 2] - 1.0).abs().max()) <= 0.2


def test_reset_object_ranges_and_parked_share():
    tt = tenvs.make_task("avoid", num_envs=20000, device="cpu", **CAM)
    obj = tt._reset_object(torch.Generator().manual_seed(3), 20000)
    parked = obj[:, 0] < -900
    assert abs(float(parked.float().mean()) - 0.2) < 0.015
    np.testing.assert_array_equal(obj[parked, 0:3].numpy(),
                                  np.tile([-999.0, -999.0, 0.0],
                                          (int(parked.sum()), 1)))
    assert float(obj[parked, 7:10].abs().max()) == 0.0
    fly = obj[~parked]
    np.testing.assert_allclose(fly[:, 0:2].norm(dim=-1).numpy(), 4.2,
                               rtol=1e-5)
    np.testing.assert_allclose(fly[:, 2].numpy(), 1.4)
    theta = torch.atan2(fly[:, 1], fly[:, 0])
    assert float(theta.abs().max()) <= np.pi / 6 + 1e-6
    np.testing.assert_allclose(fly[:, 7:9].norm(dim=-1).numpy(), 4.5,
                               rtol=1e-5)
    # the throw's ground track passes within 0.3 * sqrt(2) of the target
    # (the aim point is within 0.3 m of (0, 0, 1) per axis)
    d = fly[:, 7:9] / 4.5
    miss = (fly[:, 0] * d[:, 1] - fly[:, 1] * d[:, 0]).abs()
    assert float(miss.max()) <= 0.3 * 2 ** 0.5 + 1e-5
    assert float((fly[:, 0:2] * d).sum(-1).max()) < 0.0   # toward it
    np.testing.assert_array_equal(obj[:, 3:7].numpy(),
                                  np.tile([0.0, 0.0, 0.0, 1.0], (20000, 1)))


def test_render_step_matches_hash_pipeline():
    """render=True: the camera after the step is the fused pipeline on
    the post-physics root and the cube after its flight, with the seed
    the step drew first from the generator (one box: never culled)."""
    jt, tt, js, ts = start(1)
    obj = np.array(js.obj)
    obj[:, 0:3] = np.array(js.core.root)[:, 0:3] + np.array([1.5, 0.0, 0.0])
    js = js._replace(obj=jnp.asarray(obj))
    ts = to_port_state(js)
    gen = torch.Generator().manual_seed(1)
    act = actions(np.random.default_rng(1))
    probe = torch.Generator()
    probe.set_state(gen.get_state())
    seed = int(torch.randint(0, 2 ** 32, (), generator=probe,
                             dtype=torch.int64))
    js2, _ = jax.jit(jt.step, static_argnames=("render",))(
        js, jnp.asarray(act), render=False)
    ts2, to = tt.step(ts, torch.from_numpy(act), gen, render=True)
    scene = jdr.SceneForRender(boxes=jt._boxes(js2.obj), ground=True)
    want = np.asarray(jpr.postprocess_hash(
        jt.cam_cfg, jdr.render_depth(jt.cam_cfg, js2.core.root, scene),
        jnp.asarray([seed, 0], jnp.uint32)))
    got = to.obs["image"].numpy()
    assert got.shape == (N, 1, 32, 16) and want.max() > 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(ts2.camera, to.obs["image"])
