"""The fused rollout's plain PyTorch version vs the JAX Pallas kernel
(interpret mode) for the Balloon and Tracking tasks, from the same packed
state, weights and seed.

Obs noise and resets stay on (the hash RNG is reproducible). The state is
seeded so that the window holds time-outs (progress near 799 / 3599),
kills and, for Balloon, balloon hits (< 0.1 m). One 1024-env tile, 4
steps. Record and state within 1e-4 (float32, other summation orders in
the MLP); done / timeout flags equal. Last, one deterministic fused step
against the port's own task module, as the JAX suite's
tests/test_fused_{balloon,tracking}.py hold the Pallas kernel."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airgym_tpu.ops import fused_rollout as jfr
from airgym_tpu_torch.ops import fused_rollout as tfr

N, H = 1024, 4


def shapes(obs):
    return [(64, obs), (64, 1), (128, 64), (128, 1), (64, 128), (64, 1),
            (4, 64), (4, 1), (1, 64), (1, 1), (4, 1), (obs, 1), (obs, 1)]


def lemniscate(prog):
    t = prog.astype(np.float32) * np.float32(0.0025)
    den = 1.0 + np.cos(t) ** 2
    return np.stack([3 * np.sin(t) / den, 3 * np.sin(t) * np.cos(t) / den,
                     np.ones_like(t)])


def make_inputs(task, seed=0):
    obs = tfr._TASK_OBS[task]
    rng = np.random.default_rng(seed)
    pack = [rng.normal(0, 1 / np.sqrt(s[1]) if s[1] > 1 else 0.1,
                       s).astype(np.float32) for s in shapes(obs)]
    pack[10] = np.full((4, 1), -0.5, np.float32)             # logstd
    pack[12] = (np.abs(pack[12]) + 0.5).astype(np.float32)   # obs istd
    st = np.zeros((40, N), np.float32)
    q = rng.normal(0, 0.05, (4, N))
    q[3] = 1.0
    st[3:7] = q / np.linalg.norm(q, axis=0)
    st[10:13] = rng.uniform(-0.2, 0.2, (3, N))
    st[13:19] = rng.uniform(-0.1, 0.1, (6, N))
    st[20] = rng.uniform(size=N) < 0.1      # fresh resets: zero thrust
    st[21:25] = rng.uniform(0, 1, (4, N))
    st[25:29] = rng.uniform(0, 0.3, (4, N))
    if task == "balloon":
        st[0:2] = rng.uniform(-0.1, 0.1, (2, N))
        st[2] = rng.uniform(0.9, 1.1, N)
        st[7] = rng.uniform(0.2, 0.6, N)                 # flying forward
        st[8:10] = rng.uniform(-0.2, 0.2, (2, N))
        st[19] = rng.integers(0, 100, N)
        st[19, :50] = 797                                # time out
        st[29] = rng.uniform(2.0, 3.0, N)                # balloon ahead
        st[30] = rng.uniform(-2.0, 2.0, N)
        st[31] = rng.uniform(0.7, 1.3, N)
        st[29:32, 50:80] = st[0:3, 50:80] + np.array([[0.06], [0.02], [0.0]])
        st[32:35] = st[0:3] - rng.uniform(0, 0.01, (3, N))  # pre_root_pos
        st[7, 80:100] = -0.3                             # flying backwards
    else:
        st[19] = rng.integers(0, 100, N)
        st[19, :50] = 3597                               # time out
        st[0:3] = lemniscate(st[19]) + rng.uniform(-0.1, 0.1, (3, N))
        st[7:10] = rng.uniform(-0.5, 0.5, (3, N))
        st[0, 50:80] += 1.5                              # off the track: die
    return st, pack


@pytest.mark.parametrize("task", ["balloon", "tracking"])
def test_plain_task_rollout_matches_pallas_interpret(task):
    st, pack = make_inputs(task)
    seed = 987654321
    jo, jr = jfr.rollout_fused_policy(
        jnp.asarray(st), jfr.PolicyPack(*map(jnp.asarray, pack)),
        jnp.array([seed], jnp.int32), H, obs_noise=True, interpret=True,
        task=task)
    to, tr = tfr.rollout_fused_policy(
        torch.from_numpy(st), tfr.PolicyPack(*map(torch.from_numpy, pack)),
        seed, H, obs_noise=True, task=task)
    jo, jr = np.asarray(jo), np.asarray(jr)
    rec, obs = tfr.rec_len(task), tfr._TASK_OBS[task]
    assert tr.shape == (H, rec, N) == jr.shape and to.shape == (40, N)
    flags = slice(obs + 11, obs + 13)
    np.testing.assert_array_equal(tr[:, flags].numpy(), jr[:, flags])
    # the window holds time-outs, kills and (Balloon) hits
    assert jr[:, obs + 12].sum() >= 40
    assert (jr[:, obs + 11] - jr[:, obs + 12]).sum() >= 30
    if task == "balloon":
        assert (jr[:, obs + 10] > 400).sum() >= 20
    np.testing.assert_allclose(tr.numpy(), jr, atol=1e-4, rtol=0)
    own = 35 if task == "balloon" else 29
    np.testing.assert_allclose(to[:own].numpy(), jo[:own], atol=1e-4, rtol=0)
    # rows the task does not own pass through unchanged
    np.testing.assert_array_equal(to[own:].numpy(), st[own:])


def test_task_shapes_and_refusals():
    for task, obs in (("balloon", 18), ("tracking", 48)):
        st, pack = make_inputs(task)
        p = tfr.PolicyPack(*map(torch.from_numpy, pack))
        assert tfr.flat_policy(p).numel() == (18157 if obs == 18 else 20137)
        assert tfr.rec_len(task) == obs + 13
        wrong = "tracking" if task == "balloon" else "balloon"
        with pytest.raises(ValueError, match="w0"):
            tfr.rollout_fused_policy(torch.from_numpy(st), p, 0, 1,
                                     task=wrong)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfr.rollout_fused_policy(torch.from_numpy(st), p, 0, 1, task="avoid")


@pytest.mark.parametrize("task", ["balloon", "tracking"])
def test_fused_step_matches_module_step(task):
    """One deterministic step (sigma ~ 0, no obs noise) of the fused
    rollout's plain version against the task module driven by the policy
    mean: reward within rtol 1e-3 / atol 5e-3 (polynomial vs native
    atan2, and Balloon's guidance term is 30x a difference of distances),
    root within 2e-3, on the envs that do not reset."""
    import airgym_tpu_torch.envs as tenvs
    from airgym_tpu_torch.models.actor_critic import ActorCritic
    from airgym_tpu_torch.ops import fused_hovering as tfh
    from airgym_tpu_torch.rl.running_stats import RunningMeanStd
    t = tenvs.make_task(task, ctl_mode="rate", num_envs=N, obs_noise=False,
                        device="cpu")
    state = t.initial_state(torch.Generator().manual_seed(0))
    model = ActorCritic(t.num_obs, 4,
                        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        model.logstd.fill_(-20.0)
    rms = RunningMeanStd.create((t.num_obs,))
    if task == "balloon":
        packed = tfr.pack_state_balloon(state.core, state.balloon,
                                        state.pre_root_pos)
        obs = t._observations(state.core.root, state.balloon, None)
    else:
        packed = tfh.pack_state(state.core)
        obs = t.observations(state.core.root, state.core.progress, None)[0]
    out, rec = tfr.rollout_fused_policy(packed, tfr.pack_policy(model, rms),
                                        5, 1, obs_noise=False, task=task)
    np.testing.assert_allclose(rec[0, :t.num_obs].T.numpy(), obs.numpy(),
                               atol=1e-5)
    with torch.no_grad():
        mu, _, _ = model(obs, rms)
    ns, step = t.step(state, torch.clamp(mu, -1.0, 1.0), None)
    kept = ~step.reset.numpy()
    assert kept.mean() > 0.3
    np.testing.assert_array_equal(rec[0, t.num_obs + 11].numpy() > 0.5,
                                  step.reset.numpy())
    np.testing.assert_allclose(rec[0, t.num_obs + 10].numpy()[kept],
                               step.reward.numpy()[kept], rtol=1e-3,
                               atol=5e-3)
    root_f = out[0:13].T.numpy()[kept]
    root_s = ns.core.root.numpy()[kept]
    sign = np.sign(np.sum(root_f[:, 3:7] * root_s[:, 3:7], axis=1,
                          keepdims=True))
    root_f[:, 3:7] *= sign
    np.testing.assert_allclose(root_f, root_s, atol=2e-3)
    if task == "balloon":
        np.testing.assert_allclose(out[32:35].T.numpy()[kept],
                                   ns.pre_root_pos.numpy()[kept], atol=1e-4)
