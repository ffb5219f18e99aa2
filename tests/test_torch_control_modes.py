"""PyTorch port vs the JAX reference: the PX4 cascade's pos / vel / atti /
prop modes, the tasks stepping in every mode, and the per-mode action
limits.

The cascade runs at 1024 random states over 5 carried steps (the
controller state threads through them) against JAX ``px4.run`` and the
C++ cascade (``airgym_tpu/control/native.py``), atol 1e-5. The task steps
start from the JAX task's own state, converted, with obs noise off, over
a window without resets, atol 2e-5 (the rate-mode env test's)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import airgym_tpu.envs as jenvs
import airgym_tpu_torch.envs as tenvs
from airgym_tpu.control import native
from airgym_tpu.control import px4 as jpx4
from airgym_tpu_torch.control import px4 as tpx4
from airgym_tpu_torch.envs.hovering import HoveringState
from test_torch_env import assert_core_close, assert_out_close, to_port_core
from test_torch_trainer import to_port_env_state

N = 1024
MODES = ("pos", "vel", "atti", "prop")


def random_states(rng, n=N):
    pos = rng.uniform(-2, 2, (n, 3))
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    vel = rng.uniform(-3, 3, (n, 3))
    angvel = rng.uniform(-3, 3, (n, 3))
    return np.concatenate([pos, q, vel, angvel], 1).astype(np.float32)


def random_actions(rng, mode, n=N):
    """Actions over the mode's whole limits, some past them (the cascade
    clamps the thrust and the rotor commands itself)."""
    lo, hi = jpx4.action_limits(mode)
    span = hi - lo
    return rng.uniform(lo - 0.1 * span, hi + 0.1 * span,
                       (n, len(lo))).astype(np.float32)


@pytest.mark.parametrize("mode", MODES)
def test_cascade_mode_matches_jax_and_cpp(mode):
    rng = np.random.default_rng(["pos", "vel", "atti", "prop"].index(mode))
    g = jpx4.CascadeGains()
    jcs, tcs = jpx4.init_state(N), tpx4.init_state(N)
    cpp = native.ParallelControl(mode, N)
    for step in range(5):
        s, a = random_states(rng), random_actions(rng, mode)
        jc, jcs = jpx4.run(mode, g, jcs, jnp.asarray(s), jnp.asarray(a), 0.01)
        tc, tcs = tpx4.run(mode, tpx4.CascadeGains(), tcs,
                           torch.from_numpy(s), torch.from_numpy(a), 0.01)
        cc = cpp.update(s, a, 0.01)
        assert tc.shape == (N, 4) and tc.dtype == torch.float32
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5,
                                   err_msg=f"{mode} step {step} vs JAX")
        np.testing.assert_allclose(tc.numpy(), cc, atol=1e-5,
                                   err_msg=f"{mode} step {step} vs C++")
        for f in jcs._fields:
            np.testing.assert_allclose(getattr(tcs, f).numpy(),
                                       np.asarray(getattr(jcs, f)),
                                       atol=1e-5, err_msg=f"{mode} {f}")
    # the controller state the C++ cascade carried agrees as well
    for name, leaf in zip(tcs._fields, jax.tree.leaves(
            cpp.state_as_pytree())):
        np.testing.assert_allclose(getattr(tcs, name).numpy(),
                                   np.asarray(leaf), atol=1e-5,
                                   err_msg=f"{mode} {name} vs C++")
    if mode == "prop":
        assert all(torch.equal(x, y) for x, y in
                   zip(tcs, tpx4.init_state(N)))
    with pytest.raises(ValueError, match="unknown control mode"):
        tpx4.run("thrust", tpx4.CascadeGains(), tcs, torch.from_numpy(s),
                 torch.from_numpy(a), 0.01)


def _mild_actions(rng, mode, n):
    """Policy-space actions in [-1, 1] that keep every env alive over the
    window: small setpoints, a commanded qw > 0 in atti."""
    a = rng.uniform(-0.3, 0.3, (n, tpx4.num_actions(mode)))
    if mode == "atti":
        a[:, 0] = rng.uniform(0.8, 1.0, n)
        a[:, -1] = -0.69 + rng.uniform(-0.05, 0.05, n)
    elif mode == "rate":
        a[:, -1] = -0.69 + rng.uniform(-0.05, 0.05, n)
    elif mode == "prop":
        a = 0.1533 + rng.uniform(-0.02, 0.02, (n, 4))
    return a.astype(np.float32)


@pytest.mark.parametrize("mode", MODES + ("rate",))
def test_task_steps_in_each_mode_match_jax(mode):
    """Hovering and Tracking from the JAX task's own state: ten steps in
    ``mode`` with the same actions give the same obs, rewards, reward
    terms, flags and state; the thrust mapping applies in rate and atti
    only, and atti dies when the commanded qw is negative."""
    n = 64
    rng = np.random.default_rng(7)
    for name in ("hovering", "tracking"):
        jt = jenvs.make_task(name, ctl_mode=mode, num_envs=n,
                             obs_noise=False)
        tt = tenvs.make_task(name, ctl_mode=mode, num_envs=n,
                             obs_noise=False, device="cpu")
        js = jt.initial_state(jax.random.PRNGKey(3))
        if name == "hovering":
            ts = HoveringState(core=to_port_core(js.core))
        else:
            ts = to_port_env_state(name, js)
        gen = torch.Generator().manual_seed(0)
        jstep = jax.jit(jt.step)
        for _ in range(10):
            act = _mild_actions(rng, mode, n)
            js, jo = jstep(js, jnp.asarray(act))
            ts, to = tt.step(ts, torch.from_numpy(act), gen)
            assert not bool(np.asarray(jo.reset).any()), (name, mode)
            assert_out_close(jo, to)
            assert_core_close(js.core, ts.core)
            for f in ("vel_int", "prev_vel_err", "yaw_sp"):
                np.testing.assert_allclose(
                    getattr(ts.core.ctrl, f).numpy(),
                    np.asarray(getattr(js.core.ctrl, f)), atol=2e-5)
        act = torch.from_numpy(_mild_actions(rng, mode, n))
        np.testing.assert_allclose(
            tt.remap_actions(act).numpy(),
            np.asarray(jt.remap_actions(jnp.asarray(act.numpy()))),
            atol=1e-7)
        if mode == "atti":
            act[:8, 0] = -0.5
            _, to = tt.step(ts, act, gen)
            assert bool(to.reset[:8].all())


@pytest.mark.parametrize("name", tenvs.registered_tasks())
def test_action_limits_and_num_actions_match_jax(name):
    """Every task, every mode: the limits (with the task's per-mode
    overrides) and the action count are the JAX task's."""
    kw = {"maplanning": dict(num_envs=2), "depthgen": dict(num_envs=2)}.get(
        name, dict(num_envs=4))
    for mode in tpx4.CONTROL_MODES:
        jt = jenvs.make_task(name, ctl_mode=mode, **kw)
        tt = tenvs.make_task(name, ctl_mode=mode, device="cpu", **kw)
        assert tt.cfg.num_actions == jt.cfg.num_actions == (
            5 if mode == "atti" else 4)
        for m in tpx4.CONTROL_MODES:
            for a, b in zip(tt.action_limits(m), jt.action_limits(m)):
                np.testing.assert_array_equal(a, b, err_msg=f"{name} {m}")
        np.testing.assert_array_equal(tt._act_lo.numpy(),
                                      np.asarray(jt._act_lo))
        np.testing.assert_array_equal(tt._act_hi.numpy(),
                                      np.asarray(jt._act_hi))
