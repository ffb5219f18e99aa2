"""The env-only fused Hovering rollout: its plain PyTorch version vs the
JAX Pallas kernel (interpret mode), from the same packed state, constant
action and seed, with resets and time-outs in the window.

Tolerances are those of tests/test_fused_hovering.py: root state within
1e-4 and reward sums within 1e-3 (the plain version and the Pallas kernel
round alike, so the real gap is far smaller); the reset flags equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airgym_tpu.ops import fused_hovering as jfh
from airgym_tpu_torch.ops import fused_hovering as tfh

N, T = 1024, 12


def make_state(seed=0):
    rng = np.random.default_rng(seed)
    st = np.zeros((40, N), np.float32)
    st[0:3] = rng.uniform(-1, 1, (3, N))
    q = rng.normal(0, 0.1, (4, N))
    q[3] = 1.0
    st[3:7] = q / np.linalg.norm(q, axis=0)
    st[7:10] = rng.uniform(-0.5, 0.5, (3, N))
    st[10:13] = rng.uniform(-0.2, 0.2, (3, N))
    st[13:19] = rng.uniform(-0.1, 0.1, (6, N))
    st[19] = rng.integers(0, 100, N)
    st[19, :64] = 2390                      # time out within the window
    st[2, 64:128], st[9, 64:128] = 1.95, 2.0    # leave the box upward
    st[20] = rng.uniform(size=N) < 0.1      # fresh resets: zero thrust
    st[21:25] = rng.uniform(0, 1, (4, N))
    st[25:29] = rng.uniform(0, 0.3, (4, N))
    st[29:40] = rng.normal(size=(11, N))    # not the step's: pass through
    return st


@pytest.mark.parametrize("motor_alpha", [0.0, 0.6])
def test_plain_env_rollout_matches_pallas_interpret(motor_alpha):
    st = make_state()
    act = np.array([0.3, -0.2, 0.1, 0.62], np.float32)
    seed = 24681357
    jo, jr = jfh.rollout_fused(jnp.asarray(st), jnp.asarray(act),
                               jnp.array([seed], jnp.int32), T,
                               interpret=True, motor_alpha=motor_alpha)
    to, tr = tfh.rollout_fused(torch.from_numpy(st), torch.from_numpy(act),
                               seed, T, motor_alpha=motor_alpha)
    jo, jr = np.asarray(jo), np.asarray(jr)
    assert to.shape == (40, N) and tr.shape == (N,)
    # resets happened (progress restarted below the count of steps run)
    # and the reset flags agree
    assert (jo[19] < T).sum() >= 100
    np.testing.assert_array_equal(to[20].numpy(), jo[20])
    np.testing.assert_array_equal(to[19].numpy(), jo[19])
    np.testing.assert_allclose(to[0:29].numpy(), jo[0:29], atol=1e-4, rtol=0)
    np.testing.assert_allclose(tr.numpy(), jr, atol=1e-3, rtol=0)
    np.testing.assert_array_equal(to[29:].numpy(), st[29:])


def test_reset_draws_keep_state_in_distribution():
    """Full thrust for 200 steps: envs climb out of the box and reset
    many times; the state stays finite, unit-quaternion and in range."""
    st = make_state(1)
    out, rew = tfh.rollout_fused(torch.from_numpy(st),
                                 torch.tensor([0.0, 0.0, 0.0, 1.0]), 9, 200)
    root = out[0:13].numpy()
    assert np.isfinite(root).all() and np.isfinite(rew.numpy()).all()
    assert np.abs(root[0:3]).max() < 4.0
    np.testing.assert_allclose(np.linalg.norm(root[3:7], axis=0), 1.0,
                               atol=1e-3)


def test_checks_and_build_entry():
    st = torch.zeros((40, N))
    with pytest.raises(ValueError, match="action"):
        tfh.rollout_fused(st, torch.zeros(3), 0, 1)
    with pytest.raises(ValueError, match="multiple of 1024"):
        tfh.rollout_fused(torch.zeros((40, 512)), torch.zeros(4), 0, 1)
    assert tfh.KERNEL.source.name == "fused_hovering.cu"
    assert tfh.KERNEL.source.exists()
    assert "fused_hovering_launch" in tfh.KERNEL.entry_points
