"""Cameras taller than 126 rows: the port renders them as the JAX package
does, the raw depth (the raw depth kernel on the card) then an unfused
post-process, whose hash noise indexes the pixels as u * H + v where the
fused kernels' u * 128 + v would give two pixels one index.

The JAX package holds its two noise pipelines to each other by
distribution (tests/test_fused_render.py::test_hash_noise_distribution:
the final image's mean within 3%, its std within 6%); the port's tall
path is held to JAX ``render/depth.postprocess`` the same way, on the
same raw depth.
Images of at most 126 rows keep their index, so the fused pipeline and
its mirrors are bitwise unchanged."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airgym_tpu.render import depth as jdr
from airgym_tpu.render import pallas_raycast as jpr
from airgym_tpu_torch import envs as tenvs
from airgym_tpu_torch.render import depth as tdr
from airgym_tpu_torch.render import raycast as trc
from test_torch_render import roots_np, scene_np, to_jax, to_torch

TALL = 240


def assert_moments_close(a, b):
    """tests/test_fused_render.py's thresholds."""
    assert abs(a.mean() - b.mean()) / a.mean() < 0.03, (a.mean(), b.mean())
    assert abs(a.std() - b.std()) / a.std() < 0.06, (a.std(), b.std())


@pytest.mark.parametrize("height", [127, TALL])
def test_tall_noise_matches_jax_postprocess_by_moments(height):
    """The same raw depth (uniform in [0, 6) m) through JAX's threefry
    postprocess and the port's tall hash pipeline. 512 envs: each env's
    random blur taps scale its whole image, so the image's moments spread
    with the env count; at tests/test_fused_render.py's 64 envs two
    pipelines of one distribution differ in std by up to 6.6% from seed
    to seed, at 512 by under 1%."""
    raw = jax.random.uniform(jax.random.PRNGKey(0), (512, 32, height),
                             minval=0.0, maxval=6.0)
    jcfg = jdr.CameraCfg(width=32, height=height)
    tcfg = tdr.CameraCfg(width=32, height=height)
    a = np.asarray(jdr.postprocess(jcfg, raw, jax.random.PRNGKey(1)))
    b = trc.postprocess_hash(tcfg, torch.from_numpy(np.array(raw)),
                             12345).numpy()
    assert a.shape == b.shape == (512, 1, 32, height)
    assert_moments_close(a, b)
    # the additive noise alone: N(0, 0.1) over the tall index
    seeds = trc._env_seeds(7, 64)
    draw = trc.hr.make_uniform(seeds[:, None],
                               trc._pixel_lanes(32, height)[None])
    noise = (0.1 * trc._normal(draw)).numpy()
    assert abs(noise.mean()) < 2e-3 and abs(noise.std() - 0.1) < 2e-3


def test_no_pixel_index_collides():
    """u * 128 + v gives two pixels one index above 128 rows (the
    trap); the tall index is the flat one, and up to 126 rows the index is
    u * 128 + v as before."""
    w = 212
    u = torch.arange(w)[:, None]
    v = torch.arange(TALL)[None]
    old = (u * 128 + v).reshape(-1)
    assert old.unique().numel() < w * TALL
    for h in (127, 128, 200, TALL):
        lanes = trc._pixel_lanes(w, h)
        assert lanes.unique().numel() == w * h, h
        assert torch.equal(lanes, torch.arange(w * h))
    for h in (16, 120, 126):
        vv = torch.arange(h)[None]
        assert torch.equal(trc._pixel_lanes(w, h),
                           (u * 128 + vv).reshape(-1)), h


def test_short_cameras_bitwise_unchanged():
    """At 126 rows the port's post-process is still the JAX hash mirror
    (to tests/test_fused_render.py's 1e-5), and each env alone, under
    the seed offset to it, is its row bit for bit (the envs are
    independent, as the post-process's chunks of envs assume)."""
    raw = np.random.default_rng(3).uniform(0.0, 6.0, (8, 24, 126)).astype(
        np.float32)
    cfg = tdr.CameraCfg(width=24, height=126)
    got = trc.postprocess_hash(cfg, torch.from_numpy(raw), 99)
    key = jnp.asarray([99, 0], jnp.uint32)
    want = np.asarray(jpr.postprocess_hash(
        jdr.CameraCfg(width=24, height=126), jnp.asarray(raw), key))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    alone = [trc.postprocess_hash(cfg, torch.from_numpy(raw[i:i + 1]),
                                  trc.offset_seed(99, i)) for i in range(8)]
    assert torch.equal(got, torch.cat(alone, 0))


def test_tall_render_and_process_is_raw_depth_then_postprocess():
    """render_and_process at 32 x 240 is the raw depth culled at the
    clamp depth then the tall post-process, bit for bit; the raw depth,
    clamped, is JAX's renderer's (as
    tests/test_torch_render_depth.py holds the plain version to it)."""
    n = 6
    s = scene_np(n=n, seed=5)
    r = roots_np(n, seed=6)
    tcfg = tdr.CameraCfg(width=32, height=TALL)
    ts, tr = to_torch(s), torch.from_numpy(r)
    got = tdr.render_and_process(tcfg, tr, ts, 4321)
    depth = trc.render_depth_fused(tcfg, tr, ts, cull_far_z=4.5)
    assert torch.equal(got, trc.postprocess_hash(tcfg, depth, 4321))
    assert got.shape == (n, 1, 32, TALL)
    ref = np.asarray(jdr.render_depth(jdr.CameraCfg(width=32, height=TALL),
                                      jnp.asarray(r), to_jax(s)))
    a, b = np.minimum(ref, 4.5), np.minimum(depth.numpy(), 4.5)
    close = np.abs(a - b) < 1e-2
    assert close.mean() > 0.995, close.mean()
    assert (b < 4.5).mean() > 0.2                      # the scene is hit


def test_tall_customized_renders():
    """A Customized task at 32 x 240 steps and renders through it."""
    task = tenvs.make_task("customized", num_envs=2, cam_width=32,
                           cam_height=TALL, device="cpu")
    gen = torch.Generator().manual_seed(0)
    s = task.initial_state(gen)
    s, out = task.step(s, torch.zeros((2, 4)), gen, render=True)
    img = out.obs["image"]
    assert img.shape == (2, 1, 32, TALL) and bool(torch.isfinite(img).all())
    assert float(img.max()) > 0.0
