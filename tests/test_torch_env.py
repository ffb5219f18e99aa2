"""PyTorch port vs the JAX reference: the Hovering env step by step.

Both sides start from the same state and take the same actions. The JAX
resets and obs noise draw from jax.random, whose bits PyTorch cannot
reproduce, so the step-by-step comparison runs with obs_noise off over a
window without resets, and the reset draws are checked by their bounds
and spread."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import airgym_tpu.envs as jenvs
import airgym_tpu_torch.envs as tenvs
from airgym_tpu_torch.control import px4 as tpx4
from airgym_tpu_torch.envs import base as tbase
from airgym_tpu_torch.envs.hovering import HoveringState
from airgym_tpu_torch.math import rotations as trot

N = 64


def to_port_core(core) -> tbase.EnvState:
    t = lambda a: torch.from_numpy(np.array(a))
    return tbase.EnvState(
        root=t(core.root), ctrl=tpx4.CascadeState(*(t(x) for x in core.ctrl)),
        progress=t(core.progress), pre_actions=t(core.pre_actions),
        reset_buf=t(core.reset_buf), rotors=t(core.rotors))


def make_pair(obs_noise=False):
    jt = jenvs.make_task("hovering", ctl_mode="rate", num_envs=N,
                         obs_noise=obs_noise)
    tt = tenvs.make_task("hovering", ctl_mode="rate", num_envs=N,
                         obs_noise=obs_noise, device="cpu")
    return jt, tt


def hover_actions(rng):
    return np.concatenate(
        [rng.uniform(-0.3, 0.3, (N, 3)),
         -0.69 + rng.uniform(-0.05, 0.05, (N, 1))], 1).astype(np.float32)


def assert_out_close(jo, to, atol=2e-5):
    np.testing.assert_allclose(to.obs.numpy(), np.asarray(jo.obs), atol=atol)
    np.testing.assert_allclose(to.reward.numpy(), np.asarray(jo.reward),
                               atol=atol)
    np.testing.assert_array_equal(to.reset.numpy(), np.asarray(jo.reset))
    np.testing.assert_array_equal(to.timeout.numpy(), np.asarray(jo.timeout))
    for k, v in jo.info.items():
        np.testing.assert_allclose(to.info[k].numpy(), np.asarray(v),
                                   atol=atol, err_msg=k)


def assert_core_close(jc, tc, atol=2e-5):
    np.testing.assert_allclose(tc.root.numpy(), np.asarray(jc.root),
                               atol=atol)
    for f in ("rate_int", "prev_rate"):
        np.testing.assert_allclose(getattr(tc.ctrl, f).numpy(),
                                   np.asarray(getattr(jc.ctrl, f)), atol=atol)
    np.testing.assert_allclose(tc.pre_actions.numpy(),
                               np.asarray(jc.pre_actions), atol=atol)
    np.testing.assert_array_equal(tc.progress.numpy(),
                                  np.asarray(jc.progress))
    np.testing.assert_array_equal(tc.reset_buf.numpy(),
                                  np.asarray(jc.reset_buf))


def test_hovering_steps_match_jax_without_resets():
    jt, tt = make_pair()
    js = jt.initial_state(jax.random.PRNGKey(0))
    ts = HoveringState(core=to_port_core(js.core))
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    jstep = jax.jit(jt.step)
    for _ in range(25):
        act = hover_actions(rng)
        js, jo = jstep(js, jnp.asarray(act))
        ts, to = tt.step(ts, torch.from_numpy(act), gen)
        assert not bool(np.asarray(jo.reset).any()), "window must not reset"
        assert_out_close(jo, to)
        assert_core_close(js.core, ts.core)


def test_timeout_reset_semantics_match_jax():
    """Episode-length resets: the pre-reset obs and the timeout flag are
    returned, the env is re-randomized at the end of the step, and the
    first step after it applies zero thrust."""
    jt, tt = make_pair()
    js = jt.initial_state(jax.random.PRNGKey(1))
    max_len = jt.cfg.max_episode_length
    prog = np.asarray(js.core.progress).copy()
    prog[:8] = max_len - 2
    js = js._replace(core=js.core._replace(progress=jnp.asarray(prog),
                                           reset_buf=jnp.zeros(N, bool)))
    ts = HoveringState(core=to_port_core(js.core))
    gen = torch.Generator().manual_seed(1)
    act = hover_actions(np.random.default_rng(1))
    js2, jo = jax.jit(jt.step)(js, jnp.asarray(act))
    ts2, to = tt.step(ts, torch.from_numpy(act), gen)
    assert_out_close(jo, to)
    assert bool(to.timeout[:8].all()) and not bool(to.reset[8:].any())

    core = ts2.core
    assert (core.progress[:8] == 0).all() and bool(core.reset_buf[:8].all())
    for x in (core.pre_actions, core.ctrl.rate_int, core.ctrl.prev_rate,
              core.rotors):
        assert float(x[:8].abs().max()) == 0.0
    # the surviving envs evolve exactly as on the JAX side
    np.testing.assert_allclose(core.root[8:].numpy(),
                               np.asarray(js2.core.root)[8:], atol=2e-5)
    # the re-randomized roots lie inside the reset distribution's support
    r = core.root[:8]
    assert float(r[:, 0:3].abs().max()) <= 1.0
    assert float(r[:, 7:10].abs().max()) <= 0.5
    assert float(r[:, 10:13].abs().max()) <= 0.2
    # first post-reset step: zero rotor commands for the reset envs only
    cmds, _ = tt.run_controller(core, tt.remap_actions(torch.from_numpy(act)))
    assert float(cmds[:8].abs().max()) == 0.0
    assert float(cmds[8:].abs().max()) > 0.0


def test_reset_draws_bounds_and_spread():
    tt = tenvs.make_task("hovering", ctl_mode="rate", num_envs=4096,
                         device="cpu")
    root = tt.randomize_hover_reset(torch.Generator().manual_seed(3), 4096)
    again = tt.randomize_hover_reset(torch.Generator().manual_seed(3), 4096)
    assert torch.equal(root, again)
    pos, q, v, w = root[:, 0:3], root[:, 3:7], root[:, 7:10], root[:, 10:13]
    assert float(pos.abs().max()) <= 1.0 and float(v.abs().max()) <= 0.5
    assert float(w.abs().max()) <= 0.2
    np.testing.assert_allclose(q.norm(dim=-1).numpy(), 1.0, atol=1e-6)
    e = trot.quat_to_euler_xyz(q)
    assert float(e[:, 0:2].abs().max()) <= 0.01 * math.pi + 1e-5
    assert float(e[:, 2].abs().max()) <= 0.05 * math.pi + 1e-5
    # U(-1, 1): mean 0, std 1/sqrt(3)
    np.testing.assert_allclose(pos.mean(0).numpy(), 0.0, atol=0.05)
    np.testing.assert_allclose(pos.std(0).numpy(), 1 / math.sqrt(3),
                               atol=0.03)


def test_obs_noise_scales():
    tt = tenvs.make_task("hovering", ctl_mode="rate", num_envs=4096,
                         device="cpu")
    root = tt.randomize_hover_reset(torch.Generator().manual_seed(4), 4096)
    noisy = tt.state_obs18(root, torch.Generator().manual_seed(5))
    clean = tenvs.make_task("hovering", ctl_mode="rate", num_envs=4096,
                            obs_noise=False, device="cpu").state_obs18(
                                root, None)
    std = (noisy - clean).std(0).numpy()
    want = np.array([1e-3] * 9 + [5e-3] * 3 + [2e-2] * 3 + [4e-1] * 3)
    np.testing.assert_allclose(std, want, rtol=0.06)


def test_make_task_refuses_what_is_not_ported(monkeypatch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tenvs.make_task("customized", device="cpu")
    # every control mode of the reference is ported; an unknown one raises
    for mode in ("pos", "vel", "atti", "prop"):
        assert tenvs.make_task("hovering", ctl_mode=mode,
                               device="cpu").cfg.ctl_mode == mode
    with pytest.raises(ValueError, match="unknown control mode"):
        tenvs.make_task("hovering", ctl_mode="thrust", device="cpu")
    with pytest.raises(KeyError):
        tenvs.make_task("no_such_task", device="cpu")
    # entry points default to cuda and never fall back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tenvs.make_task("hovering")
