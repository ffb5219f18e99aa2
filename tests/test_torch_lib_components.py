"""The port's library surface against the JAX package's on the same numpy
inputs: the loss functions, the moving-stats updates, the schedulers,
TensorPID, the quadrotor accessors, usd_rotations, the config helpers,
tr_helpers, the replay buffers and segment trees, the checkpoint retry
and the episode logger. float32 results agree within 1e-6 of max|ref|
(relative), the float64 / numpy copies within 1e-12."""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airgym_tpu.physics import quadrotor as jquad
from airgym_tpu.rl import losses as jlosses
from airgym_tpu.rl import moving_stats as jms
from airgym_tpu.rl import replay as jreplay
from airgym_tpu.rl import schedulers as jsched
from airgym_tpu.rl import tr_helpers as jtr
from airgym_tpu.utils import helpers as jhelpers
from airgym_tpu.utils import logger as jlogger
from airgym_tpu.utils import tensor_pid as jpid
from airgym_tpu.utils import usd_rotations as jusd
from airgym_tpu_torch.physics import quadrotor as tquad
from airgym_tpu_torch.rl import checkpoint as tckpt
from airgym_tpu_torch.rl import losses as tlosses
from airgym_tpu_torch.rl import moving_stats as tms
from airgym_tpu_torch.rl import replay as treplay
from airgym_tpu_torch.rl import schedulers as tsched
from airgym_tpu_torch.rl import tr_helpers as ttr
from airgym_tpu_torch.utils import helpers as thelpers
from airgym_tpu_torch.utils import logger as tlogger
from airgym_tpu_torch.utils import tensor_pid as tpid
from airgym_tpu_torch.utils import usd_rotations as tusd

B, A = 256, 4


def close32(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-6,
                               atol=1e-6 * max(float(np.abs(ref).max()), 1e-30))


def close64(out, ref):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


def both(*arrays):
    """float32 numpy arrays -> (torch tensors, jnp arrays)."""
    arrays = [np.asarray(a, np.float32) for a in arrays]
    return ([torch.from_numpy(a) for a in arrays],
            [jnp.asarray(a) for a in arrays])


def loss_inputs(seed=0):
    rng = np.random.default_rng(seed)
    old = rng.normal(1.0, 0.5, B)
    new = old + rng.normal(0.0, 0.3, B)       # ratios on both clip sides
    return old, new, rng.normal(0.0, 1.0, B), rng


# --------------------------------------------------------------------------
# losses


@pytest.mark.parametrize("name", ["actor_loss", "smoothed_actor_loss"])
@pytest.mark.parametrize("is_ppo", [True, False])
def test_actor_losses_match_jax(name, is_ppo):
    old, new, adv, _ = loss_inputs()
    t, j = both(old, new, adv)
    close32(getattr(tlosses, name)(*t, is_ppo, 0.2),
            getattr(jlosses, name)(*j, is_ppo, 0.2))


@pytest.mark.parametrize("name", ["default_critic_loss", "critic_loss"])
@pytest.mark.parametrize("clip_value", [True, False])
def test_critic_losses_match_jax(name, clip_value):
    rng = np.random.default_rng(1)
    vp, v, ret = (rng.normal(0, 2, B) for _ in range(3))
    t, j = both(vp, v, ret)
    close32(getattr(tlosses, name)(t[0], t[1], 0.2, t[2], clip_value),
            getattr(jlosses, name)(j[0], j[1], 0.2, j[2], clip_value))


def test_decoupled_loss_and_diagnostics_match_jax():
    old, new, adv, rng = loss_inputs(2)
    proxy = new + rng.normal(0.0, 0.2, B)
    t, j = both(old, new, proxy, adv)
    close32(tlosses.decoupled_actor_loss(*t, 0.2),
            jlosses.decoupled_actor_loss(*j, 0.2))
    close32(tlosses.policy_clip_fraction(t[1], t[0], 0.2),
            jlosses.policy_clip_fraction(j[1], j[0], 0.2))
    close32(tlosses.explained_variance(t[1], t[0]),
            jlosses.explained_variance(j[1], j[0]))


def test_bound_and_kl_match_jax():
    rng = np.random.default_rng(3)
    mu0, mu1 = rng.normal(0, 1.5, (B, A)), rng.normal(0, 1.5, (B, A))
    s0, s1 = np.exp(rng.normal(-0.5, 0.3, (2, B, A)))
    t, j = both(mu0, s0, mu1, s1)
    close32(tlosses.bound_loss(t[0]), jlosses.bound_loss(j[0]))
    close32(tlosses.bound_loss(t[0], 0.5), jlosses.bound_loss(j[0], 0.5))
    for reduce in (True, False):
        close32(tlosses.policy_kl(*t, reduce), jlosses.policy_kl(*j, reduce))


# --------------------------------------------------------------------------
# moving stats


@pytest.mark.parametrize("shape", [(), (3,)])
@pytest.mark.parametrize("update", ["update_mean_std", "update_min_max",
                                    "update_percentile"])
def test_moving_stats_match_jax(update, shape):
    rng = np.random.default_rng(4)
    ms_t = tms.MovingStats.create(shape, device="cpu")
    ms_j = jms.MovingStats.create(shape)
    for i in range(4):
        x = rng.normal(1.0 + i, 2.0, (64, 8) + shape)
        t, j = both(x)
        ms_t = getattr(tms, update)(ms_t, t[0], decay=0.9)
        ms_j = getattr(jms, update)(ms_j, j[0], decay=0.9)
        close32(ms_t.center, ms_j.center)
        close32(ms_t.scale, ms_j.scale)
        assert float(ms_t.initialized) == float(ms_j.initialized) == 1.0
    y = rng.normal(0.0, 1.0, (16,) + shape)
    t, j = both(y)
    close32(tms.normalize(ms_t, t[0]), jms.normalize(ms_j, j[0]))
    close32(tms.denormalize(ms_t, t[0]), jms.denormalize(ms_j, j[0]))


def test_percentile_past_quantile_limit():
    """torch.quantile refuses more than 2^24 elements; the port's
    percentile sorts, and there agrees with numpy's linear percentile (the
    rule jnp.percentile follows; the JAX sort of 2^24 floats on the CPU
    takes tens of seconds)."""
    x = np.random.default_rng(5).normal(0.0, 1.0, 2 ** 24 + 3).astype(
        np.float32)
    lo, hi = tms.percentiles(torch.from_numpy(x), (5.0, 95.0))
    close32(lo, np.percentile(x, 5.0).astype(np.float32))
    close32(hi, np.percentile(x, 95.0).astype(np.float32))


# --------------------------------------------------------------------------
# schedulers, PID, accessors, rotations, helpers


def test_schedulers_match_jax():
    for kl in (0.1, 0.008, 0.001):
        lr_t, e_t = tsched.AdaptiveScheduler().update(3e-4, 0.01, 0, 0, kl)
        lr_j, e_j = jsched.AdaptiveScheduler().update(
            jnp.asarray(3e-4), 0.01, 0, 0, jnp.asarray(kl))
        close32(lr_t, lr_j)
        assert e_t == e_j
    for kw in (dict(use_epochs=True), dict(use_epochs=False),
               dict(apply_to_entropy=True, start_entropy_coef=0.02)):
        lin_t = tsched.LinearScheduler(start_lr=1e-3, max_steps=100, **kw)
        lin_j = jsched.LinearScheduler(start_lr=1e-3, max_steps=100, **kw)
        for step in (0, 37, 100, 150):
            out_t = lin_t.update(None, 0.0, step, 2 * step, 0.0)
            out_j = lin_j.update(None, 0.0, step, 2 * step, 0.0)
            close32(np.asarray(out_t, np.float32),
                    np.asarray([float(v) for v in out_j], np.float32))
    for name, kw in (("adaptive", dict(kl_threshold=0.01, start_lr=1.0)),
                     ("linear", dict(start_lr=1e-3)), ("none", {})):
        assert (type(tsched.make(name, **kw)).__name__
                == type(jsched.make(name, **kw)).__name__)


def test_tensor_pid_matches_jax():
    rng = np.random.default_rng(6)
    args = dict(kp=1.0, ki=0.5, kd=0.1, integral_lim=0.05,
                derivative_lim=30.0, output_lim=1.5)
    pid_t, pid_j = tpid.TensorPID(**args), jpid.TensorPID(**args)
    st_t, st_j = pid_t.init((16, 3), device="cpu"), pid_j.init((16, 3))
    for i in range(5):
        t, j = both(rng.normal(0.0, 1.0, (16, 3)))
        out_t, st_t = pid_t.step(st_t, t[0], 0.01)
        out_j, st_j = pid_j.step(st_j, j[0], 0.01)
        close32(out_t, out_j)
        if i == 2:
            mask = rng.random(16) < 0.5
            st_t = pid_t.reset(st_t, torch.from_numpy(mask))
            st_j = pid_j.reset(st_j, jnp.asarray(mask))
        close32(st_t.integral, st_j.integral)
        close32(st_t.prev_error, st_j.prev_error)


def test_quadrotor_accessors_match_jax():
    s = np.random.default_rng(7).normal(size=(5, 2, 13))
    t, j = both(s)
    for name in ("positions", "quats", "linvels", "angvels"):
        np.testing.assert_array_equal(getattr(tquad, name)(t[0]).numpy(),
                                      np.asarray(getattr(jquad, name)(j[0])))


def test_usd_rotations_match_jax():
    rng = np.random.default_rng(8)
    q = rng.normal(size=(6, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    e = rng.uniform(-1.5, 1.5, (6, 3))
    mats = jusd.quats_to_rot_matrices(q)
    cases = [("euler_angles_to_quats", (e,)),
             ("euler_angles_to_quats", (np.rad2deg(e[0]), True)),
             ("quats_to_euler_angles", (q,)),
             ("quats_to_euler_angles", (q[1], True)),
             ("rot_matrices_to_quats", (mats,)),
             ("quats_to_rot_matrices", (q[2],)),
             ("rotvecs_to_quats", (e,)),
             ("quats_to_rotvecs", (q,)),
             ("rad2deg", (e,)), ("deg2rad", (e,))]
    for name, args in cases:
        close64(getattr(tusd, name)(*args), getattr(jusd, name)(*args))

    class GfQuat:
        def GetReal(self):
            return 0.5

        def GetImaginary(self):
            return (0.5, -0.5, 0.5)

    close64(tusd.gf_quat_to_tensor(GfQuat()),
            jusd.gf_quat_to_tensor(GfQuat()))


@dataclasses.dataclass(frozen=True)
class _Cfg:
    num_envs: int = 8
    ctl_mode: str = "rate"
    episode_length_s: float = 24.0
    target: tuple = (0.0, 1.0)


class _Tree:
    class env:
        num_envs = 4
        spacing = 1.5

    class control:
        mode = "rate"
        gains = [1.0, 2.0]


def test_config_helpers_match_jax():
    for obj in (_Cfg(), _Tree(), 3, "x"):
        assert thelpers.class_to_dict(obj) == jhelpers.class_to_dict(obj)
    for args in ({"num_envs": 64, "seed": 3}, {"ctl_mode": "vel"},
                 {"episode_length_s": 5.0, "num_envs": None}, {}):
        assert (thelpers.update_cfg_from_args(_Cfg(), args)
                == jhelpers.update_cfg_from_args(_Cfg(), args))


# --------------------------------------------------------------------------
# tr_helpers


def test_tr_helpers_match_jax():
    rng = np.random.default_rng(9)
    r = rng.normal(2.0, 3.0, B).astype(np.float32)
    for kw in (dict(scale_value=0.1, shift_value=0.5),
               dict(scale_value=2.0, min_val=-1.0, max_val=4.0),
               dict(shift_value=20.0, log_val=True)):
        ref = jtr.DefaultRewardsShaper(**kw)(jnp.asarray(r))
        close32(ttr.DefaultRewardsShaper(**kw)(torch.from_numpy(r)), ref)
        close32(ttr.DefaultRewardsShaper(**kw)(r), ref)

    dicts = [{"a": rng.normal(size=3), "b": np.float64(i)} for i in range(4)]
    for batch, ds in ((True, dicts), (False, [{"a": d["a"]} for d in dicts])):
        out_t = ttr.dicts_to_dict_with_arrays(ds, batch)
        out_j = jtr.dicts_to_dict_with_arrays(ds, batch)
        assert out_t.keys() == out_j.keys()
        for k in out_t:
            close64(out_t[k], out_j[k])

    obs = {"image": r[:8].reshape(2, 4), "observation": r[8:11]}
    out_t, out_j = ttr.unsqueeze_obs(obs), jtr.unsqueeze_obs(obs)
    for k in obs:
        assert out_t[k].shape == out_j[k].shape == (1,) + obs[k].shape
    assert ttr.unsqueeze_obs(r).shape == (1, B)

    m_t, m_j = ttr.AverageMeter((2,), max_size=10), \
        jtr.AverageMeter((2,), max_size=10)
    for n in (3, 0, 8, 1, 12):
        v = rng.normal(size=(n, 2))
        m_t.update(v)
        m_j.update(v)
        close64(m_t.get_mean(), m_j.get_mean())
        assert len(m_t) == len(m_j)
    m_t.update(np.ones(2))
    m_j.update(np.ones(2))
    close64(m_t.get_mean(), m_j.get_mean())

    d_t, d_j = ttr.DatasetList(), jtr.DatasetList()
    for i in range(3):
        part = {"a": np.arange(5) + 5 * i, "b": rng.normal(size=(5, 2))}
        d_t.add(part)
        d_j.add(part)
    mb_t, mb_j = list(d_t.minibatches(4)), list(d_j.minibatches(4))
    assert len(mb_t) == len(mb_j) == 3
    for a, b in zip(mb_t, mb_j):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(mb_t[1]["a"], np.arange(4, 8))


# --------------------------------------------------------------------------
# replay


def test_segment_trees_match_jax():
    rng = np.random.default_rng(10)
    trees = [(cls(64), getattr(jreplay, cls.__name__)(64))
             for cls in (treplay.SumSegmentTree, treplay.MinSegmentTree)]
    for _ in range(5):
        idx = rng.integers(0, 64, 20)
        val = rng.random(20) + 0.01
        for t, j in trees:
            t[idx] = val
            j[idx] = val
    for t, j in trees:
        close64(t.tree, j.tree)
        close64(t.reduce(), j.reduce())
        close64(t[np.arange(64)], j[np.arange(64)])
    s_t, s_j = trees[0]
    mass = rng.random(50) * s_t.reduce()
    np.testing.assert_array_equal(s_t.find_prefixsum_idx(mass),
                                  s_j.find_prefixsum_idx(mass))


def fill(buf, n, rng):
    for i in range(n):
        buf.add(np.full(3, i, np.float32), rng.normal(size=2),
                float(i), np.full(3, i + 1, np.float32), float(i % 2))


@pytest.mark.parametrize("prioritized", [False, True])
def test_host_buffers_draw_as_jax(prioritized):
    """The same seeds draw the same indices, transitions, weights and
    priorities."""
    if prioritized:
        make = lambda mod: mod.PrioritizedReplayBuffer(
            48, alpha=0.6, obs_shape=(3,), action_shape=(2,))
    else:
        make = lambda mod: mod.ReplayBuffer(48, (3,), (2,))
    b_t, b_j = make(treplay), make(jreplay)
    fill(b_t, 70, np.random.default_rng(11))        # wraps the 48-ring
    fill(b_j, 70, np.random.default_rng(11))
    assert len(b_t) == len(b_j) == 48
    g_t, g_j = np.random.default_rng(12), np.random.default_rng(12)
    for _ in range(3):
        if prioritized:
            out_t = b_t.sample(16, beta=0.4, rng=g_t)
            out_j = b_j.sample(16, beta=0.4, rng=g_j)
            np.testing.assert_array_equal(out_t[-1], out_j[-1])   # indices
            new_p = g_t.random(16) + 0.1
            b_t.update_priorities(out_t[-1], new_p)
            b_j.update_priorities(out_j[-1], g_j.random(16) + 0.1)
        else:
            out_t, out_j = b_t.sample(16, rng=g_t), b_j.sample(16, rng=g_j)
        for a, b in zip(out_t, out_j):
            close64(a, b)
    if prioritized:
        close64(b_t._sum.tree, b_j._sum.tree)
        close64(b_t._min.tree, b_j._min.tree)
        assert b_t._max_priority == b_j._max_priority


def test_vectorized_replay_matches_jax_after_wrap():
    rng = np.random.default_rng(13)
    vb_t = treplay.VectorizedReplayBuffer((4,), (2,), 32, device="cpu")
    vb_j = jreplay.VectorizedReplayBuffer((4,), (2,), capacity=32)
    st_t, st_j = vb_t.create(), vb_j.create()
    for i in range(7):                          # 7 x 10 rows wrap twice
        obs, act, nobs = (rng.normal(size=(10, w)).astype(np.float32)
                          for w in (4, 2, 4))
        rew = rng.normal(size=10).astype(np.float32)
        done = rng.random(10) < 0.3
        st_t = vb_t.add(st_t, torch.from_numpy(obs), torch.from_numpy(act),
                        torch.from_numpy(rew), torch.from_numpy(nobs),
                        torch.from_numpy(done))
        st_j = vb_j.add(st_j, jnp.asarray(obs), jnp.asarray(act),
                        jnp.asarray(rew), jnp.asarray(nobs),
                        jnp.asarray(done))
        for name in treplay.VectorizedReplayState._fields:
            a, b = getattr(st_t, name).numpy(), np.asarray(getattr(st_j,
                                                                   name))
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=f"{name} add {i}")
    assert int(vb_t.size(st_t)) == int(vb_j.size(st_j)) == 32


def test_vectorized_replay_samples_stored_rows():
    vb = treplay.VectorizedReplayBuffer((3,), (1,), 64, device="cpu")
    st = vb.create()
    gen = torch.Generator().manual_seed(0)
    assert vb.sample(st, gen, 4)[0].shape == (4, 3)         # empty: row 0
    rows = torch.arange(20, dtype=torch.float32)
    st = vb.add(st, rows[:, None].expand(20, 3), torch.zeros(20, 1),
                rows, rows[:, None].expand(20, 3) + 1, torch.zeros(20))
    obs, act, rew, nobs, done = vb.sample(st, gen, 2048)
    assert int(vb.size(st)) == 20 and not bool(st.full)
    assert set(rew.long().tolist()) == set(range(20))
    np.testing.assert_array_equal(obs[:, 0].numpy(), rew.numpy())
    np.testing.assert_array_equal(nobs[:, 0].numpy(), rew.numpy() + 1)
    with pytest.raises(ValueError, match="does not fit"):
        vb.add(st, torch.zeros(65, 3), torch.zeros(65, 1), torch.zeros(65),
               torch.zeros(65, 3), torch.zeros(65))


# --------------------------------------------------------------------------
# checkpoint retries, logger


def test_safe_filesystem_op_retries_then_succeeds(monkeypatch):
    sleeps, calls = [], []
    monkeypatch.setattr(tckpt.time, "sleep", sleeps.append)

    def flaky(x, y=0):
        calls.append(x)
        if len(calls) <= 2:
            raise OSError("stale NFS handle")
        return x + y

    assert tckpt.safe_filesystem_op(flaky, 2, y=3) == 5
    assert calls == [2, 2, 2] and sleeps == pytest.approx([0.1, 0.2])


def test_safe_filesystem_op_raises_when_attempts_run_out(monkeypatch):
    sleeps = []
    monkeypatch.setattr(tckpt.time, "sleep", sleeps.append)
    errors = [OSError(f"attempt {i}") for i in range(3)]

    def broken():
        raise errors[len(sleeps)]

    with pytest.raises(OSError) as info:
        tckpt.safe_filesystem_op(broken, attempts=3)
    assert info.value is errors[-1]
    assert sleeps == pytest.approx([0.1, 0.2, 0.3])

    def wrong():
        raise ValueError("not a filesystem error")

    with pytest.raises(ValueError):
        tckpt.safe_filesystem_op(wrong)
    assert len(sleeps) == 3                     # no retry


def test_checkpoint_io_goes_through_retries(tmp_path, monkeypatch):
    """save / load / export_pth / import_pth each retry an OSError."""
    from airgym_tpu_torch import envs as tenvs
    from airgym_tpu_torch.rl import ppo as tppo
    task = tenvs.make_task("hovering", num_envs=8, device="cpu")
    tr = tppo.PPO(task, tppo.PPOConfig(horizon=4, minibatch_size=32))
    ts = tr.init(0)
    monkeypatch.setattr(tckpt.time, "sleep", lambda s: None)
    real_save, real_load = torch.save, torch.load
    failures = []

    def once(fn):
        def wrapped(*a, **kw):
            if len(failures) % 2 == 0:
                failures.append(fn.__name__)
                raise OSError("transient")
            failures.append("ok")
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tckpt.torch, "save", once(real_save))
    monkeypatch.setattr(tckpt.torch, "load", once(real_load))
    tckpt.save(str(tmp_path / "a.pt"), ts)
    ck = tckpt.load(str(tmp_path / "a.pt"))
    tckpt.export_pth(str(tmp_path / "a.pth"), ts)
    tckpt.import_pth(str(tmp_path / "a.pth"), tr.make_model())
    assert failures == ["save", "ok", "load", "ok"] * 2
    monkeypatch.setattr(tckpt.torch, "load", real_load)
    for k, v in ts.model.state_dict().items():
        assert torch.equal(ck["model"][k], v)


def test_episode_logger_matches_jax_without_matplotlib(monkeypatch, capsys,
                                                       tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)   # import fails
    lg_t, lg_j = tlogger.EpisodeLogger(0.01), jlogger.EpisodeLogger(0.01)
    rng = np.random.default_rng(14)
    for i in range(5):
        z = rng.normal()
        lg_t.log_state("z", torch.tensor(z, dtype=torch.float32))
        lg_j.log_state("z", np.float32(z))
        lg_t.log_states({"vx": i * 0.5, "vy": torch.tensor(1.0 - i)})
        lg_j.log_states({"vx": i * 0.5, "vy": np.float64(1.0 - i)})
        r = rng.normal(size=8).astype(np.float32)
        lg_t.log_rewards({"pos": torch.from_numpy(r)}, 2)
        lg_j.log_rewards({"pos": r}, 2)
    assert dict(lg_t.state_log) == dict(lg_j.state_log)
    assert lg_t.num_episodes == lg_j.num_episodes == 10
    close64(lg_t.rew_log["pos"], lg_j.rew_log["pos"])
    capsys.readouterr()
    lg_t.print_rewards()
    out_t = capsys.readouterr().out
    lg_j.print_rewards()
    assert out_t == capsys.readouterr().out
    with pytest.raises(ImportError):
        lg_t.plot_states(str(tmp_path / "states.png"))
    lg_t.reset()
    assert not lg_t.state_log and lg_t.num_episodes == 0
    assert lg_t.plot_states(str(tmp_path / "none.png")) is None


def test_episode_logger_plots(tmp_path):
    pytest.importorskip("matplotlib")
    lg = tlogger.EpisodeLogger(0.01)
    for i in range(10):
        lg.log_states({"z": 0.1 * i, "vz": torch.tensor(1.0)})
    out = lg.plot_states(str(tmp_path / "states.png"))
    assert out == str(tmp_path / "states.png")
    assert (tmp_path / "states.png").stat().st_size > 0
