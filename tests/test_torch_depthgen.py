"""PyTorch port vs the JAX reference: the DepthGen dataset generator.

The scene of the same variants and placements matches the JAX package's
``_scene`` to 1e-6 (the placement yaw's cos / sin may differ by an ulp).
A step from the same state gives the same observation (noise off), zero
rewards and a reset of every env (2-step episodes); its camera image,
the clean clamped depth through the raw depth kernel's plain version, is
held against the JAX step's (on the CPU the JAX package renders with its
``render_depth`` oracle) where they agree to 1e-2, at least 99.5% of the
pixels, as tests/test_pallas_raycast.py holds the Pallas kernel."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import airgym_tpu.envs as jenvs
import airgym_tpu_torch.envs as tenvs
from airgym_tpu_torch.envs.depthgen import DepthGenState
from airgym_tpu_torch.render import raycast as trc
from test_torch_env import to_port_core

N = 3
CAM = dict(cam_width=32, cam_height=16)
FIELDS = ("thin", "tree", "cube", "flag")


def make_pair():
    jt = jenvs.make_task("depthgen", num_envs=N, obs_noise=False, **CAM)
    tt = tenvs.make_task("depthgen", num_envs=N, obs_noise=False,
                         device="cpu", **CAM)
    return jt, tt


def to_port_state(js) -> DepthGenState:
    t = lambda a: torch.from_numpy(np.array(a))
    kw = {}
    for f in FIELDS:
        kw[f"{f}_variant"] = t(getattr(js, f"{f}_variant")).long()
        kw[f"{f}_pos"] = t(getattr(js, f"{f}_pos"))
        kw[f"{f}_yaw"] = t(getattr(js, f"{f}_yaw"))
    return DepthGenState(core=to_port_core(js.core), camera=t(js.camera),
                         counter=int(js.counter), **kw)


def test_scene_matches_jax():
    jt, tt = make_pair()
    js = jt.initial_state(jax.random.PRNGKey(0))
    ts = to_port_state(js)
    jsc, tsc = jt._scene(js), tt.scene(ts)
    for kind in ("cylinders", "spheres", "boxes", "annuli"):
        a, b = getattr(tsc, kind), getattr(jsc, kind)
        for f in b._fields:
            got, want = getattr(a, f).numpy(), np.asarray(getattr(b, f))
            assert got.shape == want.shape, (kind, f)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                       err_msg=f"{kind}.{f}")
    assert tsc.ground
    inp = trc.prepare(tt.cam_cfg, ts.core.root, tsc)
    assert inp.counts == (75, 72, 15, 3) and inp.prims.shape == (N, 168, 12)


def test_two_step_episodes_zero_reward_and_render_match_jax():
    jt, tt = make_pair()
    js = jt.initial_state(jax.random.PRNGKey(1))
    js = js._replace(counter=jnp.asarray(3, jnp.int32))   # this step renders
    ts = to_port_state(js)
    act = np.zeros((N, 4), np.float32)
    js2, jo = jax.jit(jt.step)(js, jnp.asarray(act))
    ts2, to = tt.step(ts, torch.from_numpy(act), torch.Generator())
    np.testing.assert_allclose(to.obs.numpy(), np.asarray(jo.obs), atol=2e-5)
    assert to.obs.shape == (N, 18)
    assert float(to.reward.abs().max()) == 0.0
    assert bool(to.reset.all()) and bool(to.timeout.all())
    assert (ts2.core.progress == 0).all() and bool(ts2.core.reset_buf.all())
    # the variants stay, the placements are drawn anew
    for f in FIELDS:
        assert torch.equal(getattr(ts2, f"{f}_variant"),
                           getattr(ts, f"{f}_variant"))
        assert not torch.equal(getattr(ts2, f"{f}_pos"), getattr(ts, f"{f}_pos"))
    got, want = ts2.camera.numpy(), np.asarray(js2.camera)
    assert got.shape == (N, 1, 32, 16)
    assert 0.0 <= got.min() and got.max() <= 1.0 and got.min() < 0.9
    close = np.abs(got - want) < 1e-2
    assert close.mean() > 0.995, close.mean()
    # the next step keeps the image (cam_every 4)
    ts3, _ = tt.step(ts2, torch.from_numpy(act), torch.Generator())
    assert torch.equal(ts3.camera, ts2.camera)


def test_initial_state_draw_ranges():
    tt = tenvs.make_task("depthgen", num_envs=512, device="cpu", **CAM)
    st = tt.initial_state(torch.Generator().manual_seed(3))
    for f, fam, k in (("thin", "thin", 100), ("tree", "trees", 1),
                      ("cube", "cubes", 8), ("flag", "flags", 4)):
        v = getattr(st, f"{f}_variant")
        assert v.shape == (512, 3) and int(v.min()) == 0
        assert int(v.max()) == k - 1, fam
        pos, yaw = getattr(st, f"{f}_pos"), getattr(st, f"{f}_yaw")
        assert 0.0 <= float(pos[..., 0].min()) and float(
            pos[..., 0].max()) <= 3.0
        assert float(pos[..., 1].abs().max()) <= 2.0
        assert float(yaw.abs().max()) <= np.pi
    root = st.core.root
    np.testing.assert_allclose(root[:, 0:2].numpy(),
                               np.tile([-0.3, 0.0], (512, 1)), atol=1e-7)
    assert 0.45 - 1e-6 <= float(root[:, 2].min()) and float(
        root[:, 2].max()) <= 0.75 + 1e-6
    assert tt.cfg.max_episode_length == 2 and tt.cfg.cam_every == 4


def test_generate_writes_transposed_frames(tmp_path):
    tt = tenvs.make_task("depthgen", num_envs=N, device="cpu", **CAM)
    assert tt.generate(str(tmp_path), n_frames=5, seed=1) == 5
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 5
    frames = [np.load(os.path.join(tmp_path, f)) for f in files]
    for img in frames:
        assert img.shape == (16, 32) and img.dtype == np.float32
        assert np.isfinite(img).all() and 0.0 <= img.min()
        assert img.max() <= 1.0 and img.min() < 1.0
    # the first frames are the first render, transposed
    g = torch.Generator().manual_seed(1)
    st = tt.initial_state(g)
    for _ in range(4):
        st, _ = tt.step(st, torch.zeros((N, 4)), g)
    first = {f: np.load(os.path.join(tmp_path, f)) for f in files
             if f.endswith("_0.npy")}
    assert any(np.array_equal(img, st.camera[0, 0].numpy().T)
               for img in first.values())
