"""PyTorch port vs the JAX reference: scene primitives, the scene packing
and culling prepass, and the fused render + post-process pipeline.

The same numpy-made scenes and drone poses go through both packages. The
port's plain version of the render kernel is held against the Pallas
kernel in interpret mode (guarded and unguarded) and against the JAX
hash mirror ``postprocess_hash(render_depth(...))``, at rtol / atol 1e-5
as tests/test_fused_render.py holds the Pallas kernel; the seed crosses
as ``_key_to_seed(key)``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airgym_tpu.physics import scene as jsc
from airgym_tpu.render import depth as jdr
from airgym_tpu.render import pallas_raycast as jpr
from airgym_tpu_torch.physics import scene as tsc
from airgym_tpu_torch.render import depth as tdr
from airgym_tpu_torch.render import raycast as trc

CAM_J = jdr.CameraCfg(width=32, height=16)
CAM_T = tdr.CameraCfg(width=32, height=16)
TOL = dict(rtol=1e-5, atol=1e-5)


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def scene_np(n=3, seed=0, n_cyl=12):
    """All four kinds in front of, beside and behind the camera (so the
    cull removes some), with invalid records in each segment."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    cyl = dict(
        center=f32(np.concatenate([rng.uniform(-3, 6, (n, n_cyl, 1)),
                                   rng.uniform(-2, 2, (n, n_cyl, 1)),
                                   np.full((n, n_cyl, 1), 1.2)], -1)),
        axis=f32(_unit(np.concatenate(
            [rng.uniform(-0.3, 0.3, (n, n_cyl, 2)),
             np.ones((n, n_cyl, 1))], -1))),
        half_len=f32(rng.uniform(0.8, 1.6, (n, n_cyl))),
        radius=f32(rng.uniform(0.05, 0.4, (n, n_cyl))),
        valid=rng.uniform(size=(n, n_cyl)) > 0.15)
    sph = dict(center=f32(np.stack([rng.uniform(0.5, 4, (n, 3)),
                                    rng.uniform(-1, 1, (n, 3)),
                                    rng.uniform(0.6, 1.4, (n, 3))], -1)),
               radius=f32(rng.uniform(0.1, 0.4, (n, 3))),
               valid=np.array([[True, True, False]] * n))
    box = dict(center=f32(np.stack([rng.uniform(1, 4, (n, 3)),
                                    rng.uniform(-1.5, 1.5, (n, 3)),
                                    rng.uniform(0.3, 1.5, (n, 3))], -1)),
               yaw=f32(rng.uniform(-np.pi, np.pi, (n, 3))),
               half_extents=f32(rng.uniform(0.1, 0.5, (n, 3, 3))),
               valid=np.array([[True, False, True]] * n))
    ann = dict(center=f32(np.stack([rng.uniform(1.5, 3.5, (n, 3)),
                                    rng.uniform(-0.8, 0.8, (n, 3)),
                                    rng.uniform(0.8, 1.2, (n, 3))], -1)),
               normal=f32(_unit(np.concatenate(
                   [np.ones((n, 3, 1)), rng.uniform(-0.4, 0.4, (n, 3, 2))],
                   -1))),
               r_in=f32(rng.uniform(0.2, 0.4, (n, 3))),
               r_out=f32(rng.uniform(0.5, 0.8, (n, 3))),
               half_thick=f32(rng.uniform(0.02, 0.1, (n, 3))),
               valid=np.array([[True, True, False]] * n))
    return dict(cylinders=cyl, spheres=sph, boxes=box, annuli=ann)


def to_jax(s, ground=True):
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    return jdr.SceneForRender(
        cylinders=jsc.Cylinders(**j(s["cylinders"])) if "cylinders" in s
        else None,
        spheres=jsc.Spheres(**j(s["spheres"])) if "spheres" in s else None,
        boxes=jsc.Boxes(**j(s["boxes"])) if "boxes" in s else None,
        annuli=jsc.Annuli(**j(s["annuli"])) if "annuli" in s else None,
        ground=ground)


def to_torch(s, ground=True):
    t = lambda d: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    return tdr.SceneForRender(
        cylinders=tsc.Cylinders(**t(s["cylinders"])) if "cylinders" in s
        else None,
        spheres=tsc.Spheres(**t(s["spheres"])) if "spheres" in s else None,
        boxes=tsc.Boxes(**t(s["boxes"])) if "boxes" in s else None,
        annuli=tsc.Annuli(**t(s["annuli"])) if "annuli" in s else None,
        ground=ground)


def roots_np(n=3, seed=1):
    """Drones at z ~ 1 with yaw and some roll / pitch."""
    rng = np.random.default_rng(seed)
    r = np.zeros((n, 13), np.float32)
    r[:, 2] = rng.uniform(0.8, 1.3, n)
    r[:, 0:2] = rng.uniform(-0.3, 0.3, (n, 2))
    ang = rng.uniform(-0.25, 0.25, (n, 3))
    cr, sr = np.cos(ang[:, 0] / 2), np.sin(ang[:, 0] / 2)
    cp, sp = np.cos(ang[:, 1] / 2), np.sin(ang[:, 1] / 2)
    cy, sy = np.cos(ang[:, 2] / 2), np.sin(ang[:, 2] / 2)
    r[:, 3] = sr * cp * cy - cr * sp * sy
    r[:, 4] = cr * sp * cy + sr * cp * sy
    r[:, 5] = cr * cp * sy - sr * sp * cy
    r[:, 6] = cr * cp * cy + sr * sp * sy
    return r


# --------------------------------------------------------------------------
# primitives


def test_ray_casts_match_jax():
    s = scene_np(n=2, seed=4)
    rng = np.random.default_rng(5)
    o = np.zeros((2, 256, 3), np.float32)
    o[..., 2] = 1.0
    v = _unit(np.concatenate([np.ones((2, 256, 1)),
                              rng.uniform(-0.6, 0.6, (2, 256, 2))], -1)
              ).astype(np.float32)
    jo, jv = jnp.asarray(o), jnp.asarray(v)
    to, tv = torch.from_numpy(o), torch.from_numpy(v)
    js, ts = to_jax(s), to_torch(s)
    pairs = [(jsc.ray_cylinders, tsc.ray_cylinders, "cylinders"),
             (jsc.ray_spheres, tsc.ray_spheres, "spheres"),
             (jsc.ray_boxes, tsc.ray_boxes, "boxes"),
             (jsc.ray_annuli, tsc.ray_annuli, "annuli")]
    for jf, tf, kind in pairs:
        ref = np.asarray(jf(jo, jv, getattr(js, kind)))
        got = tf(to, tv, getattr(ts, kind)).numpy()
        assert (ref < 1e8).sum() > 5, kind            # rays do hit
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5,
                                   err_msg=kind)
    np.testing.assert_allclose(tsc.ray_ground(to, tv).numpy(),
                               np.asarray(jsc.ray_ground(jo, jv)), rtol=1e-6)


def test_distances_match_jax():
    s = scene_np(n=2, seed=6)
    p = np.random.default_rng(7).uniform(-2, 4, (2, 5, 3)).astype(np.float32)
    # a [N, Q, 3] query against [N, P] primitives: per env, per point
    js, ts = to_jax(s), to_torch(s)
    for kind, jf, tf in (("cylinders", jsc.dist_to_cylinders,
                          tsc.dist_to_cylinders),
                         ("spheres", jsc.dist_to_spheres,
                          tsc.dist_to_spheres),
                         ("boxes", jsc.dist_to_boxes, tsc.dist_to_boxes),
                         ("annuli", jsc.dist_to_annuli, tsc.dist_to_annuli)):
        jp = getattr(js, kind)
        tp = getattr(ts, kind)
        jq = type(jp)(*[jnp.expand_dims(a, 1) for a in jp])
        tq = type(tp)(*[a.unsqueeze(1) for a in tp])
        ref = np.asarray(jf(jnp.asarray(p), jq))
        got = tf(torch.from_numpy(p), tq).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5,
                                   err_msg=kind)
    q = torch.from_numpy(p[:, 0])
    ref = np.asarray(jdr.min_dist_scene(jnp.asarray(p[:, 0]), js))
    np.testing.assert_allclose(tdr.min_dist_scene(q, ts).numpy(), ref,
                               rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# packing, culling, seeds and taps


def test_pack_scene_and_cull_match_jax():
    s = scene_np(n=4, seed=8)
    r = roots_np(4, seed=9)
    js, ts = to_jax(s), to_torch(s)
    jt, jc = jpr.pack_scene(4, js)
    tt, tc = trc.pack_scene(4, ts)
    assert tc == jc == (12, 3, 3, 3)
    # cos / sin of the box yaw may differ by an ulp between the libraries
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-7)
    assert tt.shape[1] == 24                       # 21 records padded to 8s

    from airgym_tpu.math import rotations as jrot
    from airgym_tpu_torch.math import rotations as trot
    jm = jrot.quat_to_matrix(jnp.asarray(r[:, 3:7])).reshape(4, 9)
    tm = trot.quat_to_matrix(torch.from_numpy(r[:, 3:7])).reshape(4, 9)
    origin = r[:, 0:3] + np.asarray(jrot.quat_rotate(
        jnp.asarray(r[:, 3:7]), jnp.asarray(CAM_J.mount_pos, jnp.float32)))
    ct = jpr._corner_tan(CAM_J)
    assert trc._corner_tan(CAM_T) == ct
    jt2, jlive = jpr.cull_and_compact(jt, jc, jnp.asarray(origin),
                                      jm[:, jnp.array([0, 3, 6])], 4.5, ct)
    tt2, tlive = trc.cull_and_compact(tt, tc, torch.from_numpy(origin),
                                      tm[:, [0, 3, 6]], 4.5, ct)
    np.testing.assert_array_equal(tlive.numpy(), np.asarray(jlive))
    assert tlive.dtype == torch.int32
    assert int(tlive[:, 0].min()) < 12             # the cull bites
    np.testing.assert_allclose(tt2.numpy(), np.asarray(jt2), rtol=0,
                               atol=1e-7)


def test_env_seeds_and_taps_match_jax():
    for seed in (0, 123, 0xFFFFFFF0):
        js = jpr._env_seeds(jnp.uint32(seed), 300)
        ts = trc._env_seeds(seed, 300)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js, np.int64))
        np.testing.assert_array_equal(trc._hash_kernel_taps(ts).numpy(),
                                      np.asarray(jpr._hash_kernel_taps(js)))
    # a 0-d device tensor seed gives the same keys as the int
    np.testing.assert_array_equal(
        trc._env_seeds(torch.tensor(0xFFFFFFF0), 8).numpy(),
        trc._env_seeds(0xFFFFFFF0, 8).numpy())


# --------------------------------------------------------------------------
# the renderer and the fused pipeline


def test_render_depth_matches_jax():
    s = scene_np(n=3, seed=10)
    r = roots_np(3, seed=11)
    ref = np.asarray(jdr.render_depth(CAM_J, jnp.asarray(r), to_jax(s)))
    got = tdr.render_depth(CAM_T, torch.from_numpy(r), to_torch(s)).numpy()
    assert got.shape == (3, 32, 16)
    np.testing.assert_allclose(got, ref, **TOL)


def test_postprocess_hash_matches_jax():
    raw = np.random.default_rng(12).uniform(0.0, 6.0, (4, 32, 16)).astype(
        np.float32)
    key = jax.random.PRNGKey(3)
    seed = int(jpr._key_to_seed(key))
    ref = np.asarray(jpr.postprocess_hash(CAM_J, jnp.asarray(raw), key))
    got = trc.postprocess_hash(CAM_T, torch.from_numpy(raw), seed).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("guarded", [False, True])
def test_render_process_plain_matches_pallas_and_mirror(guarded):
    """All four kinds on a 32x16 camera; ``guarded`` culls at the clamp
    depth (21 records > 16), unguarded casts every record."""
    s = scene_np(n=3, seed=13)
    r = roots_np(3, seed=14)
    key = jax.random.PRNGKey(21)
    seed = int(jpr._key_to_seed(key))
    cull = CAM_J.depth_clamp if guarded else None
    js, ts = to_jax(s), to_torch(s)
    pallas = np.asarray(jpr.render_process_pallas(
        CAM_J, jnp.asarray(r), js, key, interpret=True, cull_far_z=cull))
    mirror = np.asarray(jpr.postprocess_hash(
        CAM_J, jdr.render_depth(CAM_J, jnp.asarray(r), js), key))
    got = trc.render_process_plain(CAM_T, torch.from_numpy(r), ts, seed,
                                   cull_far_z=cull).numpy()
    assert got.shape == (3, 1, 32, 16)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, mirror, **TOL)
    # render_process on CPU tensors is the plain version
    again = trc.render_process(CAM_T, torch.from_numpy(r), ts, seed,
                               cull_far_z=cull).numpy()
    np.testing.assert_array_equal(again, got)
    if guarded:
        inp = trc.prepare(CAM_T, torch.from_numpy(r), ts, seed, cull)
        assert int(inp.live[:, 0].min()) < 12      # records were culled


def test_render_process_box_scene_unguarded():
    """A one-box scene like Avoid's: too small to cull, so the cull
    request falls back to the unguarded chain."""
    s = {"boxes": scene_np(n=2, seed=15)["boxes"]}
    r = roots_np(2, seed=16)
    key = jax.random.PRNGKey(2)
    seed = int(jpr._key_to_seed(key))
    inp = trc.prepare(CAM_T, torch.from_numpy(r), to_torch(s), seed, 4.5)
    assert inp.live.tolist() == [[0, 0, 3, 0]] * 2
    pallas = np.asarray(jpr.render_process_pallas(
        CAM_J, jnp.asarray(r), to_jax(s), key, interpret=True,
        cull_far_z=4.5))
    got = trc.render_process_packed(inp).numpy()
    np.testing.assert_allclose(got, pallas, **TOL)


def test_render_and_process_refuses_tall_cameras():
    s = to_torch({"spheres": scene_np(n=1)["spheres"]})
    r = torch.from_numpy(roots_np(1))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdr.render_and_process(tdr.CameraCfg(width=32, height=130), r, s, 0)
    with pytest.raises(ValueError, match="H <= 126"):
        trc.render_process(tdr.CameraCfg(width=32, height=130), r, s, 0)
    img = tdr.render_and_process(CAM_T, r, s, 5)
    assert img.shape == (1, 1, 32, 16) and bool(torch.isfinite(img).all())
