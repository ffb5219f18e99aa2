"""PyTorch port vs the JAX reference: rotations, quadrotor physics, the PX4
rate cascade, the polynomial transcendentals and the kernels' hash RNG.

Inputs are made with numpy from a seed and handed to both sides; the
port runs on the CPU. Tolerances are float32 rounding (1e-5 absolute on
O(1) values) unless stated."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airgym_tpu.control import px4 as jpx4
from airgym_tpu.math import rotations as jrot
from airgym_tpu.ops import fused_hovering as jfh
from airgym_tpu.ops import transcendental as jtm
from airgym_tpu.physics import quadrotor as jqd
from airgym_tpu_torch.control import px4 as tpx4
from airgym_tpu_torch.math import rotations as trot
from airgym_tpu_torch.ops import fused_hovering as tfh
from airgym_tpu_torch.ops import hash_rng
from airgym_tpu_torch.ops import transcendental as ttm
from airgym_tpu_torch.physics import quadrotor as tqd
from test_golden_trajectory import GOLDEN_HOVER_CMD, GOLDEN_RATE_100

N = 256


def _quat(rng, n=N):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    euler = np.stack([rng.uniform(-3.0, 3.0, N), rng.uniform(-1.3, 1.3, N),
                      rng.uniform(-3.0, 3.0, N)], -1).astype(np.float32)
    return dict(
        q=_quat(rng), q2=_quat(rng),
        qs=(_quat(rng) * rng.uniform(0.5, 2.0, (N, 1))).astype(np.float32),
        v=rng.normal(size=(N, 3)).astype(np.float32),
        w=rng.normal(0, 5.0, size=(N, 3)).astype(np.float32),
        e=euler,
        m=np.array(jrot.euler_xyz_to_matrix(jnp.asarray(euler))),
        a=rng.uniform(-20.0, 20.0, N).astype(np.float32),
        b=rng.uniform(-20.0, 20.0, N).astype(np.float32),
    )


# (function, argument names, extra python arguments)
ROT_CASES = [
    ("quat_conjugate", ["q"], ()), ("quat_mul", ["q", "q2"], ()),
    ("quat_normalize", ["qs"], ()), ("quat_canonical", ["q"], ()),
    ("quat_rotate", ["q", "v"], ()), ("quat_rotate_inverse", ["q", "v"], ()),
    ("quat_axis", ["q"], (0,)), ("quat_axis", ["q"], (2,)),
    ("quat_to_matrix", ["q"], ()), ("matrix_to_quat", ["m"], ()),
    ("quat_from_euler_xyz", ["e"], ()), ("euler_xyz_to_matrix", ["e"], ()),
    ("matrix_to_euler_xyz", ["m"], ()), ("quat_to_euler_xyz", ["q"], ()),
    ("yaw_from_quat", ["q"], ()), ("wrap_angle", ["a"], ()),
    ("yaw_diff", ["a", "b"], ()), ("xyzw_to_wxyz", ["q"], ()),
    ("wxyz_to_xyzw", ["q"], ()), ("quat_integrate", ["q", "w"], (0.01,)),
]


@pytest.mark.parametrize("name,argnames,extra", ROT_CASES,
                         ids=[f"{c[0]}{c[2]}" for c in ROT_CASES])
def test_rotations_match_jax(name, argnames, extra):
    x = _inputs()
    ref = getattr(jrot, name)(*[jnp.asarray(x[k]) for k in argnames], *extra)
    got = getattr(trot, name)(*[torch.from_numpy(x[k]) for k in argnames],
                              *extra)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=0)


def _state(rng, n=N):
    s = np.zeros((n, 13), np.float32)
    s[:, 0:3] = rng.uniform(-1, 1, (n, 3))
    s[:, 3:7] = _quat(rng, n)
    s[:, 7:10] = rng.normal(0, 0.5, (n, 3))
    s[:, 10:13] = rng.normal(0, 1.0, (n, 3))
    return s


def test_physics_step_wrench_and_lag_match_jax():
    rng = np.random.default_rng(1)
    s = _state(rng)
    cmds = rng.uniform(0, 1, (N, 4)).astype(np.float32)
    rotors = rng.uniform(0, 1, (N, 4)).astype(np.float32)
    jp, tp = jqd.x152b_params(motor_tau=0.03), tqd.x152b_params(motor_tau=0.03)
    assert tuple(jp) == tuple(tp)
    for fn, args in ((jqd.step, (s, cmds)), (jqd.rotor_lag, (rotors, cmds))):
        ref = fn(jp, *[jnp.asarray(a) for a in args])
        got = getattr(tqd, fn.__name__)(tp, *[torch.from_numpy(a)
                                              for a in args])
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    for r, g in zip(jqd.rotor_wrench(jp, jnp.asarray(cmds)),
                    tqd.rotor_wrench(tp, torch.from_numpy(cmds))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)
    assert tqd.motor_alpha(tp) == pytest.approx(np.exp(-0.01 / 0.03))


def test_rate_cascade_matches_jax():
    rng = np.random.default_rng(2)
    s = _state(rng)
    act = np.concatenate([rng.uniform(-6, 6, (N, 3)),
                          rng.uniform(-0.2, 1.2, (N, 1))], 1).astype(
                              np.float32)
    ri = rng.uniform(-0.3, 0.3, (N, 3)).astype(np.float32)
    pr = rng.normal(0, 1, (N, 3)).astype(np.float32)
    g = jpx4.CascadeGains()
    assert tuple(g) == tuple(tpx4.CascadeGains())
    js = jpx4.init_state(N)._replace(rate_int=jnp.asarray(ri),
                                     prev_rate=jnp.asarray(pr))
    ts = tpx4.init_state(N)._replace(rate_int=torch.from_numpy(ri),
                                     prev_rate=torch.from_numpy(pr))
    jc, js2 = jpx4.run("rate", g, js, jnp.asarray(s), jnp.asarray(act), 0.01)
    tc, ts2 = tpx4.run("rate", tpx4.CascadeGains(), ts, torch.from_numpy(s),
                       torch.from_numpy(act), 0.01)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    for f in ("rate_int", "prev_rate"):
        np.testing.assert_allclose(getattr(ts2, f).numpy(),
                                   np.asarray(getattr(js2, f)), atol=1e-5)
    mask = rng.uniform(size=N) < 0.5
    jr = jpx4.reset_state(js2, jnp.asarray(mask), jnp.asarray(s[:, 3:7]))
    tr = tpx4.reset_state(ts2, torch.from_numpy(mask),
                          torch.from_numpy(s[:, 3:7]))
    for f in jr._fields:
        np.testing.assert_allclose(getattr(tr, f).numpy(),
                                   np.asarray(getattr(jr, f)), atol=1e-5)
    # the other modes from the same states and controller state (their
    # carried steps: tests/test_torch_control_modes.py)
    for mode in ("pos", "vel", "atti", "prop"):
        lo, hi = jpx4.action_limits(mode)
        a = rng.uniform(lo, hi, (N, len(lo))).astype(np.float32)
        jc, jm = jpx4.run(mode, g, js, jnp.asarray(s), jnp.asarray(a), 0.01)
        tc, tm = tpx4.run(mode, tpx4.CascadeGains(), ts, torch.from_numpy(s),
                          torch.from_numpy(a), 0.01)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5,
                                   err_msg=mode)
        for f in jm._fields:
            np.testing.assert_allclose(getattr(tm, f).numpy(),
                                       np.asarray(getattr(jm, f)), atol=1e-5,
                                       err_msg=f"{mode} {f}")


def test_golden_rate_trajectory_and_hover_command():
    """The JAX suite's golden closed-loop rate-mode trajectory, replayed by
    the port from the same start state."""
    p, g = tqd.x152b_params(), tpx4.CascadeGains()
    q0 = trot.quat_from_euler_xyz(torch.tensor([[0.1, -0.05, 0.2]]))
    s = torch.zeros((1, 13))
    s[:, 3:7] = q0
    s[:, 7:10] = torch.tensor([[0.2, -0.1, 0.0]])
    cs = tpx4.init_state(1)
    act = torch.tensor([[0.3, -0.2, 0.5, tqd.hover_command(p)]])
    for _ in range(100):
        cmds, cs = tpx4.run("rate", g, cs, s, act, 0.01)
        s = tqd.step(p, s, cmds)
    got = torch.cat([s[0, 0:3], s[0, 3:7]]).numpy()
    np.testing.assert_allclose(got, GOLDEN_RATE_100, atol=2e-4)
    np.testing.assert_allclose(tqd.hover_command(p), GOLDEN_HOVER_CMD,
                               atol=1e-6)


def test_mixer_matches_jax():
    rng = np.random.default_rng(3)
    torque = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    thrust = rng.uniform(0, 1, N).astype(np.float32)
    ref = jpx4.mix_to_rotors(jpx4.CascadeGains(), jnp.asarray(torque),
                             jnp.asarray(thrust))
    got = tpx4.mix_to_rotors(tpx4.CascadeGains(), torch.from_numpy(torque),
                             torch.from_numpy(thrust))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("fn", ["atan", "atan2", "asin", "acos"])
def test_transcendentals_match_jax(fn):
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.uniform(-3, 3, 500), rng.uniform(-1, 1, 500),
                        [0.0, 1.0, -1.0, 1e-31, -1e-31, 50.0]]).astype(
                            np.float32)
    y = np.concatenate([rng.uniform(-3, 3, 1000),
                        [0.0, 0.0, 0.0, 1.0, -1.0, -2.0]]).astype(np.float32)
    args = (y, x) if fn == "atan2" else (x,)
    ref = getattr(jtm, fn)(*[jnp.asarray(a) for a in args])
    got = getattr(ttm, fn)(*[torch.from_numpy(a) for a in args])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)


def test_hash_mix_is_bit_exact():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    ref = np.asarray(jfh._mix(jnp.asarray(x, jnp.uint32)))
    got = hash_rng.mix(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), ref)


@pytest.mark.parametrize("seed", [0, 123456789, 2 ** 31 - 2])
def test_hash_uniform_is_bit_exact_per_tile(seed):
    """Two 1024-env tiles: the tile seed comes from the env index, the
    lane is the env's index in its tile, the counter restarts at 1."""
    base, lanes = tfh.rng_base(seed, 2 * tfh.TILE, "cpu")
    for step in (0, 7):
        draw = tfh.step_uniform(base, lanes, step)
        got = np.stack([draw().numpy() for _ in range(5)])
        for tile in range(2):
            jbase = (jnp.uint32(seed) + jnp.uint32(tile)
                     * jnp.uint32(0x01000193))
            jkey = jbase ^ ((jnp.uint32(step) + jnp.uint32(1))
                            * jnp.uint32(0x9E3779B1))
            jdraw = jfh._make_uniform(jkey, (8, 128))
            ref = np.stack([np.asarray(jdraw()).reshape(-1)
                            for _ in range(5)])
            np.testing.assert_array_equal(
                got[:, tile * tfh.TILE:(tile + 1) * tfh.TILE], ref)


def test_quat_from_euler_matches_jax():
    rng = np.random.default_rng(6)
    a = [rng.uniform(-0.2, 0.2, N).astype(np.float32) for _ in range(3)]
    ref = jfh._quat_from_euler(*[jnp.asarray(v) for v in a])
    got = tfh._quat_from_euler(*[torch.from_numpy(v) for v in a])
    for r, g_ in zip(ref, got):
        np.testing.assert_allclose(g_.numpy(), np.asarray(r), atol=1e-6)
