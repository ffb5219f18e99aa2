"""PyTorch port vs the JAX reference: the asset manager and the Customized
template task.

The manager's composition is fed the JAX side's own draws (its key
splits replayed here) and held to JAX ``sample_scene``. Customized steps
start from one carried-over JAX state: steps without render compare obs,
reward and the reset / time-out / contact flags over a window without
scene resets (the fresh placements come from different generators), and
render steps hold the port's camera to the JAX hash mirror with the
camera seed the step drew first, at the 1e-5 of
tests/test_fused_render.py. A Customized subclass added with
``register`` trains through the runner."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import airgym_tpu.envs as jenvs
from airgym_tpu import assets as jassets
from airgym_tpu.assets.manager import AssetConfig as JAssetConfig
from airgym_tpu.assets.manager import AssetManager as JAssetManager
from airgym_tpu.render import depth as jdr
from airgym_tpu.render import pallas_raycast as jpr
from airgym_tpu.rl import vecenv as jvecenv
import airgym_tpu_torch.envs as tenvs
from airgym_tpu_torch import assets as tassets
from airgym_tpu_torch.assets.manager import AssetConfig, AssetManager
from airgym_tpu_torch.assets.manager import Placement, SceneDraws
from airgym_tpu_torch.envs.customized import (Customized, CustomizedCfg,
                                              CustomizedState)
from airgym_tpu_torch.physics import scene as tsc
from airgym_tpu_torch.render import depth as tdr
from airgym_tpu_torch.rl import runner as trunner
from airgym_tpu_torch.rl import vecenv as tvecenv
from test_torch_env import assert_core_close, to_port_core

N = 8
CAM = dict(cam_width=32, cam_height=16)
DICTS = dict(
    include_robot={"X152b": {"num_assets": 1}},
    include_single_asset={"balls/ball": {"num_assets": 2},
                          "cubes/1x1": {"num_assets": 1},
                          "8x18ground": {"num_assets": 1}},
    include_group_asset={"thin": {"num_assets": 3},
                         "vtrees": {"num_assets": 2},
                         "objects": {"num_assets": 2},
                         "flags": {"num_assets": 1}},
    include_boundary={"grounds/ground": {"num_assets": 1}})


def t(a):
    return torch.from_numpy(np.array(a))


def jax_draws(cfg, n, key) -> SceneDraws:
    """JAX ``AssetManager.sample_scene``'s draws, its key splits replayed
    (assets/manager.py), as the port's ``SceneDraws``."""
    def place(k, count, variant=None):
        kp, ky = jax.random.split(k)
        xy = jax.random.uniform(kp, (n, count, 2), minval=-1.0, maxval=1.0)
        yaw = jax.random.uniform(ky, (n, count), minval=-np.pi,
                                 maxval=np.pi)
        return Placement(xy=t(xy), yaw=t(yaw), variant=variant)

    single, group = [], []
    for name, count in cfg.include_single_asset:
        if count == 0:
            continue
        key, k = jax.random.split(key)
        if jassets.registry.get_asset(name).geometry == "plane":
            single.append(None)
        else:
            single.append(place(k, count))
    for name, count in cfg.include_group_asset:
        if count == 0:
            continue
        key, kv, k = jax.random.split(key, 3)
        variant = jax.random.randint(kv, (n, count), 0,
                                     jassets.num_variants(name))
        group.append(place(k, count, t(variant).long()))
    return SceneDraws(single=tuple(single), group=tuple(group))


def to_port_scene(js) -> tdr.SceneForRender:
    conv = lambda p, cls: None if p is None else cls(*[t(a) for a in p])
    return tdr.SceneForRender(
        cylinders=conv(js.cylinders, tsc.Cylinders),
        spheres=conv(js.spheres, tsc.Spheres),
        boxes=conv(js.boxes, tsc.Boxes),
        annuli=conv(js.annuli, tsc.Annuli), ground=True)


def test_asset_config_from_dicts_and_counts():
    """As tests/test_manager_customized.py: counts and the config."""
    cfg = AssetConfig.from_dicts(**DICTS, placement_y=3.0)
    jcfg = JAssetConfig.from_dicts(**DICTS, placement_y=3.0)
    assert cfg.__dict__ == jcfg.__dict__
    m, jm = AssetManager(cfg, 4), JAssetManager(jcfg, 4)
    for f in ("get_robot_count", "get_env_boundary_count",
              "get_env_asset_count", "get_env_actor_count",
              "get_robot_num_bodies"):
        assert getattr(m, f)() == getattr(jm, f)(), f
    assert m.get_env_asset_count() == 2 + 1 + 1 + 3 + 2 + 2 + 1 + 1
    assert AssetConfig.from_dicts().include_robot == (("X152b", 1),)


@pytest.mark.parametrize("seed", [0, 1])
def test_composition_of_jax_draws_matches_jax(seed):
    """Every include category, a ground board and four group families:
    the port's composition of the JAX draws equals JAX sample_scene, every
    field and the root states exactly but the yaw-rotated centers and
    directions, to 2e-6 (two float32 ulps at 8 m: the yaw's cos / sin
    may differ by an ulp between the libraries)."""
    jcfg = JAssetConfig.from_dicts(**DICTS)
    cfg = AssetConfig.from_dicts(**DICTS)
    key = jax.random.PRNGKey(seed)
    jscene, jstates = JAssetManager(jcfg, N).sample_scene(key)
    scene, states = AssetManager(cfg, N).compose(jax_draws(jcfg, N, key))
    assert scene.ground is True and jscene.ground is True
    for kind in ("cylinders", "spheres", "boxes", "annuli"):
        a, b = getattr(scene, kind), getattr(jscene, kind)
        assert (a is None) == (b is None), kind
        for f in b._fields:
            got, want = getattr(a, f).numpy(), np.asarray(getattr(b, f))
            assert got.shape == want.shape and got.dtype == want.dtype, \
                (kind, f)
            if f in ("center", "axis", "normal"):
                np.testing.assert_allclose(got, want, rtol=0, atol=2e-6,
                                           err_msg=f"{kind}.{f}")
            else:
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{kind}.{f}")
    np.testing.assert_array_equal(states.numpy(), np.asarray(jstates))
    # a ground board adds a zero root block; unit-w quaternions
    assert states.shape == (N, 12, 13)
    np.testing.assert_array_equal(states[..., 6].numpy(), 1.0)


def test_manager_sample_scene():
    """As tests/test_manager_customized.py::test_manager_sample_scene, on
    the port's own draws."""
    cfg = AssetConfig.from_dicts(
        include_single_asset={"balls/ball": {"num_assets": 1}},
        include_group_asset={"thin": {"num_assets": 3}})
    g = torch.Generator().manual_seed(0)
    scene, states = AssetManager(cfg, 4).sample_scene(
        lambda *s: torch.rand(s, generator=g),
        lambda high, *s: torch.randint(0, high, s, generator=g))
    assert scene.spheres.center.shape == (4, 1, 3)
    assert scene.cylinders.center.shape == (4, 3, 3)
    assert states.shape == (4, 4, 13)
    np.testing.assert_allclose(states[..., 6].numpy(), 1.0)
    assert float(scene.cylinders.center[..., 0].abs().max()) <= 8.5


def test_sample_tree_scene():
    """The forest of the generator's variant / position / yaw draws,
    inside its ranges."""
    g = torch.Generator().manual_seed(3)
    cyl = tassets.sample_tree_scene(g, 64, 10, 8.0, 4.0)
    g = torch.Generator().manual_seed(3)
    var = torch.randint(0, 100, (64, 10), generator=g)
    pos = (torch.rand((64, 10, 2), generator=g) * 2 - 1) * torch.tensor(
        [8.0, 4.0])
    yaw = torch.rand((64, 10), generator=g) * (2 * math.pi) - math.pi
    want = tassets.tree_cylinders_from_placement(var, pos, yaw)
    for a, b in zip(cyl, want):
        assert torch.equal(a, b)
    assert cyl.center.shape == (64, 10, 3) and bool(cyl.valid.all())
    r = torch.sqrt(torch.sum(cyl.center[..., :2] ** 2, -1))
    assert float(r.max()) < 8.0 * math.sqrt(2) + 1.0


# ---------------------------------------------------------------- the task


def make_pair(**kw):
    jt = jenvs.make_task("customized", ctl_mode="rate", num_envs=N, **CAM,
                         **kw)
    tt = tenvs.make_task("customized", ctl_mode="rate", num_envs=N,
                         device="cpu", **CAM, **kw)
    return jt, tt


def to_port_state(js) -> CustomizedState:
    return CustomizedState(core=to_port_core(js.core),
                           scene=to_port_scene(js.scene),
                           asset_states=t(js.asset_states),
                           camera=t(js.camera), counter=int(js.counter))


def start(seed=0, **kw):
    """Both sides at a fresh JAX state, the drones already flying and a
    non-trivial camera image."""
    jt, tt = make_pair(**kw)
    js = jt.initial_state(jax.random.PRNGKey(seed))
    cam = np.random.default_rng(seed).uniform(
        0.2, 3.0, js.camera.shape).astype(np.float32)
    js = js._replace(core=js.core._replace(reset_buf=jnp.zeros(N, bool)),
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
    assert set(to.info) == set(jo.info)


def test_steps_without_render_match_jax():
    jt, tt, js, ts = start(0, obs_noise=False)
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    jstep = jax.jit(jt.step, static_argnames=("render",))
    for _ in range(6):
        act = actions(rng)
        js, jo = jstep(js, jnp.asarray(act), render=False)
        ts, to = tt.step(ts, torch.from_numpy(act), gen, render=False)
        assert not bool(np.asarray(jo.reset).any()), "window must not reset"
        assert_out_close(jo, to)
        np.testing.assert_array_equal(to.obs["image"].numpy(),
                                      np.asarray(jo.obs["image"]))
        np.testing.assert_array_equal(to.priv_obs.numpy(),
                                      np.asarray(jo.priv_obs))
        assert_core_close(js.core, ts.core)
        assert ts.counter == int(js.counter)
    assert tt.obs_is_dict and not tt.has_success and tt.cam_every == 4
    assert tt.action_limits("rate")[1][0] == 1.0     # the narrow rates


def test_contacts_and_timeouts_match_jax():
    """Envs at the episode's end time out; envs inside a tree or below
    the collision radius collide and reset; flags, rewards and the
    pre-reset obs agree, and the reset envs restart at the start pose."""
    jt, tt, js, ts = start(2, obs_noise=False)
    core = js.core
    prog = np.array(core.progress)
    prog[:2] = jt.cfg.max_episode_length - 2
    root = np.array(core.root)
    root[2:4, 0:3] = np.array(js.scene.cylinders.center)[2:4, 0]  # in a tree
    root[4, 2] = 0.05                                            # ground
    js = js._replace(core=core._replace(progress=jnp.asarray(prog),
                                        root=jnp.asarray(root)))
    ts = to_port_state(js)
    act = actions(np.random.default_rng(2))
    js2, jo = jax.jit(jt.step, static_argnames=("render",))(
        js, jnp.asarray(act), render=False)
    ts2, to = tt.step(ts, torch.from_numpy(act),
                      torch.Generator().manual_seed(2), render=False)
    assert_out_close(jo, to)
    assert bool(to.timeout[:2].all()) and bool(to.reset[:5].all())
    assert not bool(to.timeout[2:5].any()) and not bool(to.reset[5:].any())
    keep = ~to.reset
    np.testing.assert_allclose(ts2.core.root[keep].numpy(),
                               np.asarray(js2.core.root)[keep.numpy()],
                               atol=2e-5)
    r = ts2.core.root[to.reset]
    np.testing.assert_allclose(r[:, 0:3].numpy(),
                               np.tile([-8.5, 0.0, 1.0], (len(r), 1)),
                               atol=1e-6)
    assert (ts2.core.progress[to.reset] == 0).all()


def test_render_steps_match_hash_pipeline():
    """render=True: the camera after the step is the fused pipeline's
    plain version on the post-physics root and the carried scene, with
    the seed the step drew first from the generator."""
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
        scene = js.scene._replace(ground=True)
        js, jo = jstep(js, jnp.asarray(act), render=False)
        ts, to = tt.step(ts, torch.from_numpy(act), gen, render=True)
        assert not bool(np.asarray(jo.reset).any())
        key = jnp.asarray([seed, 0], jnp.uint32)
        want = np.asarray(jpr.postprocess_hash(
            jt.cam_cfg, jdr.render_depth(jt.cam_cfg, js.core.root, scene),
            key))
        got = to.obs["image"].numpy()
        assert got.shape == (N, 1, 32, 16) and want.max() > 0.0
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert_core_close(js.core, ts.core)


def test_per_env_scene_reset():
    """As tests/test_manager_customized.py: when one env resets, the other
    envs' scenes and asset states keep every bit, the reset env's
    change, and the next render sees the carried scenes."""
    task = tenvs.make_task("customized", num_envs=2, obs_noise=False,
                           device="cpu", **CAM)
    gen = torch.Generator().manual_seed(3)
    s = task.initial_state(gen)
    acts = torch.zeros((2, 4))
    s, _ = task.step(s, acts, gen, render=True)
    before = [x.clone() for x in s.scene.cylinders] + [s.asset_states]
    prog = s.core.progress.clone()
    prog[0] = task.cfg.max_episode_length - 2
    s = s._replace(core=s.core._replace(progress=prog))
    s2, out = task.step(s, acts, gen, render=True)
    assert bool(out.reset[0]) and not bool(out.reset[1])
    after = list(s2.scene.cylinders) + [s2.asset_states]
    for b, a in zip(before, after):
        assert torch.equal(b[1], a[1]), "the surviving env's scene moved"
    assert not torch.equal(before[0][0], after[0][0]), \
        "the reset env's scene was not drawn anew"
    _, out3 = task.step(s2, acts, gen, render=True)
    assert out3.obs["image"].shape == (2, 1, 32, 16)


class Gates(Customized):
    """A task built on the template: reward for height, death below
    0.5 m."""
    task_name = "gates_subclass"

    def _reward(self, root, actions, pre_actions, collisions):
        z = root[:, 2]
        return (-torch.abs(z - 1.0), z < 0.5,
                {"height_reward": -torch.abs(z - 1.0)})


def test_registered_subclass_trains_through_the_runner(tmp_path):
    """register / get_cfg, then the runner builds the subclass from the
    YAML's env_name and trains it with frame dedup; a task registered
    after rl/vecenv's import is in neither framework's vec-env table."""
    try:
        tenvs.register("gates_subclass", Gates, CustomizedCfg)
        jenvs.register("gates_subclass", *jenvs._REGISTRY["customized"])
        cfg = tenvs.get_cfg("gates_subclass", num_envs=4, cam_width=32)
        assert cfg.num_envs == 4 and cfg.cam_height == 120
        assert "gates_subclass" in tenvs.registered_tasks()
        with pytest.raises(KeyError):
            tvecenv.create_vec_env("gates_subclass", 2, device="cpu")
        with pytest.raises(KeyError):
            jvecenv.create_vec_env("gates_subclass", 2)
        yaml_cfg = {"params": {
            "seed": 5,
            "network": {"mlp": {"units": [32, 32], "activation": "elu"},
                        "cnn": {"output_dim": 8}},
            "config": {
                "env_name": "gates_subclass", "num_actors": 8,
                "horizon_length": 8, "minibatch_size": 32,
                "mini_epochs": 1, "max_epochs": 2, "save_frequency": 0,
                "save_best_after": 1,
                "env_config": {"cam_width": 24, "cam_height": 20,
                               "asset_config": AssetConfig(
                                   include_group_asset=(("vtrees", 2),
                                                        ("objects", 1)))}}}}
        runner = trunner.Runner().load(yaml_cfg)
        _, trainer, _ = runner.build({"device": "cpu"})
        assert isinstance(trainer.task, Gates) and trainer.frame_dedup
        ts, info = runner.run_train({"device": "cpu",
                                     "run_root": str(tmp_path)})
    finally:
        tenvs._REGISTRY.pop("gates_subclass", None)
        jenvs._REGISTRY.pop("gates_subclass", None)
    assert info["epochs"] == 2 and ts.frame == 2 * 8 * 8
    # vtrees: 13 cylinders a tree; objects: a box or a sphere
    scene = ts.env_state.scene
    assert scene.cylinders.center.shape == (8, 26, 3)
    assert scene.boxes.center.shape == scene.spheres.center.shape[:2] + (3,)
    row = info["history"][-1]
    assert all(math.isfinite(v) for v in row.values()), row
