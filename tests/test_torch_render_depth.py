"""PyTorch port vs the JAX reference: the raw z-depth camera (the plain
version of csrc/render_depth.cu) against ``render_depth_pallas`` in
interpret mode and against the ``render_depth`` oracle.

Tolerances. Against the Pallas kernel: rtol / atol 1e-5 (``TOL``, as
tests/test_torch_render.py) on all but ``GRAZING`` of the pixels, and
rtol 1e-3 on those. XLA contracts the ray set-up's multiply-adds into
FMAs on the CPU, which the kernel, built with -fmad=false, must not do;
the ulp that moves is amplified where a ray grazes a surface (a sphere's
silhouette, where the hit distance goes with the square root of a
vanishing discriminant, or the ground near the horizon, t = -oz / uz).
The CUDA kernel and the plain version agree to the bit on the card
(chip_smoke.py). Against the oracle: where both hit and agree to 1e-2
after clipping at 10 m, at atol 1e-2 (tests/test_pallas_raycast.py).

The kernel source itself, csrc/render_depth.cu on csrc/raycast.cuh, is
also compiled for the CPU against csrc/cuda_emu.h and held against the
plain version at the card's gate (|err| <= 1e-5 where both hit, at most
max(1, N / 1000) hit / miss flips) and to the bit on a few envs at 212 x
120, with the plain version's square roots correctly rounded as on the
card. The emulated card has two SMs, so each env's image is cast in two
bands.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airgym_tpu.render import depth as jdr
from airgym_tpu.render import pallas_raycast as jpr
from airgym_tpu_torch.render import depth as tdr
from airgym_tpu_torch.render import raycast as trc
from test_torch_render import (CAM_J, CAM_T, TOL, emulate,  # noqa: F401
                               ieee_sqrt, kernel_case, roots_np, scene_np,
                               to_jax, to_torch)

GRAZING = 1e-3          # share of pixels allowed past TOL
BIG = 1e9


def assert_depth_close(got, ref):
    off = ~np.isclose(got, ref, **TOL)
    assert off.mean() <= GRAZING, (off.sum(), off.size)
    np.testing.assert_allclose(got, ref, rtol=1e-3)


def sphere_scene_np(e=2, r=4, seed=0):
    """MAPlanning's scene: per flat robot, the R robots of its env and the
    goal ball as 0.2 m spheres, robots flying level toward the goal."""
    rng = np.random.default_rng(seed)
    n = e * r
    pos = np.stack([rng.uniform(-8.5, -6.0, (e, r)), rng.uniform(-2, 2, (e, r)),
                    rng.uniform(1.3, 1.7, (e, r))], -1).astype(np.float32)
    goal = np.stack([np.full(e, 1.5), rng.uniform(-1, 1, e),
                     np.full(e, 1.5)], -1).astype(np.float32)
    centers = np.concatenate(
        [np.broadcast_to(pos[:, None], (e, r, r, 3)).reshape(n, r, 3),
         np.broadcast_to(goal[:, None, None], (e, r, 1, 3)).reshape(n, 1, 3)],
        1)
    roots = roots_np(n, seed + 1)
    roots[:, 0:3] = pos.reshape(n, 3)
    sph = dict(center=np.ascontiguousarray(centers),
               radius=np.full((n, r + 1), 0.2, np.float32),
               valid=np.ones((n, r + 1), bool))
    return {"spheres": sph}, roots


@pytest.mark.parametrize("guarded", [False, True])
def test_render_depth_plain_matches_pallas_mixed_scene(guarded):
    """All four kinds (21 records, so a cull request culls) on a 32 x 16
    camera, culled at the clamp depth or not."""
    s, r = scene_np(n=3, seed=13), roots_np(3, seed=14)
    cull = CAM_J.depth_clamp if guarded else None
    ref = np.asarray(jpr.render_depth_pallas(
        CAM_J, jnp.asarray(r), to_jax(s), interpret=True, cull_far_z=cull))
    got = trc.render_depth_plain(CAM_T, torch.from_numpy(r), to_torch(s),
                                 cull).numpy()
    assert got.shape == (3, 32, 16)
    assert_depth_close(got, ref)
    # render_depth_fused and render_depth_auto on CPU tensors: the plain
    # version, not the oracle
    fused = trc.render_depth_fused(CAM_T, torch.from_numpy(r), to_torch(s),
                                   cull).numpy()
    np.testing.assert_array_equal(fused, got)
    auto = tdr.render_depth_auto(CAM_T, torch.from_numpy(r), to_torch(s),
                                 cull).numpy()
    np.testing.assert_array_equal(auto, got)
    inp = trc.prepare(CAM_T, torch.from_numpy(r), to_torch(s), None, cull)
    assert inp.seeds is None and inp.taps is None
    if guarded:
        assert int(inp.live[:, 0].min()) < 12          # records were culled
    else:
        assert inp.live.tolist() == [[12, 3, 3, 3]] * 3


def test_render_depth_plain_matches_pallas_sphere_scene():
    """MAPlanning's 5 spheres pack to 8 records: never culled."""
    s, r = sphere_scene_np()
    ref = np.asarray(jpr.render_depth_pallas(
        CAM_J, jnp.asarray(r), to_jax(s), interpret=True, cull_far_z=4.5))
    inp = trc.prepare(CAM_T, torch.from_numpy(r), to_torch(s), None, 4.5)
    assert inp.prims.shape[1] == 8 and inp.counts == (0, 5, 0, 0)
    assert inp.live.tolist() == [[0, 5, 0, 0]] * 8
    got = trc.render_depth_packed(inp).numpy()
    assert_depth_close(got, ref)
    assert (got < 4.5).sum() > 20                      # the spheres are hit


def test_render_depth_plain_matches_oracle_and_miss_value():
    """Against the XLA renderer where both hit; a miss is BIG * inv_norm,
    as in the oracle's t / |d|, not BIG."""
    s, r = scene_np(n=3, seed=10), roots_np(3, seed=11)
    ref = np.asarray(jdr.render_depth(CAM_J, jnp.asarray(r), to_jax(s)))
    got = trc.render_depth_plain(CAM_T, torch.from_numpy(r),
                                 to_torch(s)).numpy()
    a, b = np.minimum(ref, 10.0), np.minimum(got, 10.0)
    close = np.abs(a - b) < 1e-2
    assert close.mean() > 0.995, close.mean()
    both = (ref < 1e8) & (got < 1e8) & close
    np.testing.assert_allclose(got[both], ref[both], atol=1e-2)
    miss = got >= 1e8
    assert miss.any()
    assert (got[miss] < BIG).all() and (got[miss] > 0.5 * BIG).all()
    np.testing.assert_allclose(got[miss], ref[miss], rtol=1e-5)


def test_render_depth_inputs_are_checked():
    """The raw depth inputs carry no noise, so the fused render + process
    wrapper refuses them; the raw depth kernel has no camera height
    limit."""
    s = to_torch({"spheres": scene_np(n=1)["spheres"]})
    r = torch.from_numpy(roots_np(1))
    inp = trc.prepare(CAM_T, r, s)
    with pytest.raises(ValueError, match="seed"):
        trc.render_process_packed(inp)
    tall = tdr.CameraCfg(width=8, height=130)
    img = trc.render_depth_fused(tall, r, s)
    assert img.shape == (1, 8, 130) and bool(torch.isfinite(img).all())
    bad = inp._replace(live=inp.live.to(torch.int64))
    with pytest.raises(ValueError, match="live"):
        trc.render_depth_packed(bad)


def test_render_clean_is_the_clamped_normalised_depth():
    s, r = scene_np(n=2, seed=3), roots_np(2, seed=4)
    depth = trc.render_depth_plain(CAM_T, torch.from_numpy(r), to_torch(s))
    img = tdr.render_clean(CAM_T, torch.from_numpy(r), to_torch(s))
    assert img.shape == (2, 1, 32, 16)
    want = np.clip(depth.numpy(), 0.0, 4.5) / np.float32(4.5)
    np.testing.assert_array_equal(img[:, 0].numpy(), want)


@pytest.fixture(scope="module")
def emulated_depth(tmp_path_factory):
    return emulate(trc.DEPTH_KERNEL, tmp_path_factory)


@pytest.mark.parametrize("scene", ["planning", "mixed"])
def test_kernel_source_matches_plain_on_cpu(emulated_depth, ieee_sqrt,
                                            scene):
    """csrc/render_depth.cu on the emulated card against the plain
    version (with the correctly rounded root) under the card's gate, and
    to the bit, as on the card; two runs bitwise equal."""
    kernel = emulated_depth
    inp = kernel_case(scene)
    assert int(inp.live[:, 0].min()) < inp.counts[0]     # the cull bites
    before = kernel.launches["render_depth"]
    runs = [trc.launch_depth(kernel, inp, None) for _ in range(2)]
    assert kernel.launches["render_depth"] == before + 2
    ref = trc.render_depth_packed_plain(inp)
    got = runs[0]
    assert got.shape == ref.shape == (4, 212, 120)
    assert bool(torch.isfinite(got).all())
    hit_k, hit_p = got < 1e8, ref < 1e8
    both = hit_k & hit_p
    assert float(both.float().mean()) > 0.05
    assert int((hit_k != hit_p).sum()) <= 1
    assert float((got - ref).abs()[both].max()) <= 1e-5
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(got.view(torch.int32), runs[1].view(torch.int32))
