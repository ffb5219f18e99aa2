"""The fused trainers' epoch preparation (ops/epoch_prep.py,
csrc/epoch_prep.cu): GAE, the running stats and the dataset between the
rollout kernel's record and the update kernel, at one 1024-env tile x 24
steps with dones and time-outs mixed, at 18 observation features
(Hovering, Balloon) and 48 (Tracking).

- ``epoch_prep_plain`` against the trainers' PyTorch path
  (``PPO._prepare``: compute_gae, the stats, the env-major rows, the
  observation normalisation of the fused trainers): GAE and the dataset
  rows bitwise, the float64 stats to rtol 1e-12, the normalised
  advantages (float64 mean and std in the kernels, float32 in PyTorch)
  and returns to rtol 1e-6. The PyTorch path takes its square roots
  rounded once there, as on the card (``torch.sqrt`` on the CPU can be an
  ulp off; the card's and the plain twin's are not).
- The kernel source compiled with g++ against csrc/cuda_emu.h against
  the plain twin, bitwise, two runs bitwise, three launches a call.
- Which fused trainers take the kernels, and a fused epoch through the
  plain twin against the JAX package (tests/test_torch_trainer.py's
  epochs, with the plain twin standing in for the kernels on the CPU).
"""
import dataclasses
import shutil

import pytest
import torch

import airgym_tpu_torch.envs as tenvs
import test_torch_trainer as jax_epochs
from airgym_tpu_torch.kernels import build
from airgym_tpu_torch.ops import epoch_prep as ep
from airgym_tpu_torch.parallel import dist as pdist
from airgym_tpu_torch.rl import fused_ppo
from airgym_tpu_torch.rl import ppo as tppo
from airgym_tpu_torch.rl import profiling
from airgym_tpu_torch.rl.running_stats import RunningMeanStd

N, H = 1024, 24
TASKS = {18: ("hovering", fused_ppo.FusedHoveringPPO),
         48: ("tracking", fused_ppo.FusedTrackingPPO)}
KW = dict(gamma=0.99, tau=0.95, reward_scale=0.1, value_bootstrap=True)


def make_case(obs, seed):
    """A trainer, its state with used running stats, and a record [H, obs
    + 13, N] laid out as the rollout kernel writes it: about 4% of the
    steps end an episode, half of those by time-out."""
    g = torch.Generator().manual_seed(seed)
    name, cls = TASKS[obs]
    tr = cls(tenvs.make_task(name, num_envs=N, device="cpu"),
             tppo.PPOConfig(horizon=H, minibatch_size=4096, mini_epochs=1))
    scale = 0.5 + 3.0 * torch.rand(obs, generator=g)
    shift = torch.randn(obs, generator=g)
    ts = dataclasses.replace(
        tr.init(seed),
        obs_rms=RunningMeanStd.create((obs,)).update(
            torch.randn((4096, obs), generator=g) * scale + shift),
        value_rms=RunningMeanStd.create(()).update(
            3.0 * torch.randn(4096, generator=g) - 1.0))
    rec = torch.randn((H, obs + 13, N), generator=g)
    rec[:, :obs] = rec[:, :obs] * scale[:, None] + shift[:, None]
    rec[:, obs + 10] = 10.0 * torch.rand((H, N), generator=g) - 2.0
    done = torch.rand((H, N), generator=g) < 0.04
    rec[:, obs + 11] = done.float()
    rec[:, obs + 12] = (done & (torch.rand((H, N), generator=g)
                                < 0.5)).float()
    return tr, ts, rec, torch.randn(N, generator=g)


def rollout_of(tr, ts, rec):
    """The Rollout of views of ``rec`` that FusedHoveringPPO.rollout
    builds."""
    k = rec.shape[1] - 13
    tp = lambda a: torch.transpose(a, 1, 2)
    obs, mus = tp(rec[:, :k]), tp(rec[:, k + 6:k + 10])
    sigma = torch.exp(ts.model.logstd.detach())
    return tppo.Rollout(
        obs=obs, prenorm=obs, actions=tp(rec[:, k:k + 4]),
        neglogp=rec[:, k + 4], values=rec[:, k + 5], mus=mus,
        sigmas=sigma.expand(mus.shape), rewards=rec[:, k + 10],
        dones=rec[:, k + 11] > 0.5, timeouts=rec[:, k + 12] > 0.5)


def card_sqrt(monkeypatch):
    """torch.sqrt rounded once from the exact root, as the card's."""
    sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda x: sqrt(
        x.to(torch.float64)).to(x.dtype))


@pytest.mark.parametrize("obs", [18, 48])
def test_plain_matches_the_pytorch_path(obs, monkeypatch):
    tr, ts, rec, last_value = make_case(obs, 3 + obs)
    traj = rollout_of(tr, ts, rec)
    assert not tr.prep_kernels                 # the CPU keeps PyTorch
    with monkeypatch.context() as m:
        card_sqrt(m)
        ts_t, values, returns, ds = tr._prepare(ts, traj, last_value)
        adv = tr.compute_gae(ts, traj, last_value)[1]
    p = ep.epoch_prep_plain(rec, last_value, ts.obs_rms, ts.value_rms, **KW)

    for a, b in ((p.values, values), (p.returns, returns), (p.adv, adv),
                 (p.obs_n, ds["obs"]), (p.actions, ds["actions"]),
                 (p.neglogp, ds["neglogp"]), (p.mus, ds["mus_init"])):
        assert a.shape == b.shape and torch.equal(a, b)
    for got, want in ((p.obs_rms, ts_t.obs_rms),
                      (p.value_rms, ts_t.value_rms)):
        for f in RunningMeanStd._fields:
            x, y = getattr(got, f), getattr(want, f)
            assert x.dtype == torch.float64 and x.shape == y.shape
            torch.testing.assert_close(x, y, rtol=1e-12, atol=0)
    torch.testing.assert_close(p.adv_n, ds["adv"], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(p.returns_n, ds["returns"], rtol=1e-6,
                               atol=1e-6)
    # the mix the case was built to have
    dones, timeouts = traj.dones.sum(), traj.timeouts.sum()
    assert 0 < timeouts < dones and float(p.adv_n.std()) > 0.5


@pytest.fixture(scope="module")
def emulated_kernel(tmp_path_factory):
    """csrc/epoch_prep.cu compiled with g++ against csrc/cuda_emu.h, as a
    CudaKernel with the wrapper's entry points."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    return build.build_emulated(
        ep.KERNEL, tmp_path_factory.mktemp("emu") / "libepoch_prep_emu.so")


@pytest.mark.parametrize("obs,bootstrap", [(18, True), (48, True),
                                           (18, False)])
def test_kernel_source_matches_plain_on_cpu(emulated_kernel, obs, bootstrap):
    """32 blocks of 32 envs x 8 warps, the stats block, 96 dataset
    blocks; two runs bitwise equal; three launches a call, each in the
    span of its phase."""
    _, ts, rec, last_value = make_case(obs, 11 + obs)
    kw = dict(KW, value_bootstrap=bootstrap)
    before = sum(emulated_kernel.launches.values())
    profiling.start()
    runs = [ep._kernel_prep(emulated_kernel, rec, last_value, ts.obs_rms,
                            ts.value_rms, **kw) for _ in range(2)]
    spans = profiling.stop()
    assert [r.name for r in spans] == list(ep.PHASES) * 2
    assert sum(emulated_kernel.launches.values()) == before + 6
    ref = ep.epoch_prep_plain(rec, last_value, ts.obs_rms, ts.value_rms, **kw)
    for f in ep.Prep._fields:
        want, a, b = (getattr(x, f) for x in (ref, *runs))
        for w, x, y in (zip(want, a, b) if isinstance(want, RunningMeanStd)
                        else [(want, a, b)]):
            assert w.shape == x.shape and torch.equal(w, x), f
            assert torch.equal(x, y), f


def test_wrapper_refuses_what_the_kernels_do_not_take():
    _, ts, rec, last_value = make_case(18, 1)
    args = (ts.obs_rms, ts.value_rms)
    with pytest.raises(ValueError, match="multiple of 32"):
        ep.epoch_prep(rec[..., :1000].contiguous(), last_value[:1000], *args,
                      **KW)
    with pytest.raises(ValueError, match="rec"):
        ep.epoch_prep(rec.double(), last_value, *args, **KW)
    with pytest.raises(ValueError, match="obs_rms"):
        ep.epoch_prep(rec, last_value, ts.value_rms, ts.value_rms, **KW)
    with pytest.raises(ValueError, match="last_value"):
        ep.epoch_prep(rec, last_value[:5], *args, **KW)


def _through_the_plain_twin(monkeypatch):
    """The fused trainers' epochs take ops/epoch_prep.epoch_prep on the CPU
    (its plain twin), as they take the kernels on the card: a fused
    trainer is built as if its task were on the card, then runs on the
    CPU. Returns the list that gains an entry a call."""
    calls = []
    plain = ep.epoch_prep

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)
    monkeypatch.setattr(ep, "epoch_prep", counted)
    init = fused_ppo.FusedHoveringPPO.__init__

    def as_on_the_card(self, task, *a, **k):
        device, task.device = task.device, torch.device("cuda")
        try:
            init(self, task, *a, **k)
        finally:
            task.device = device
        self.device = device
    monkeypatch.setattr(fused_ppo.FusedHoveringPPO, "__init__",
                        as_on_the_card)
    return calls


@pytest.mark.parametrize("change", [
    None, dict(normalize_value=False), dict(normalize_advantage=False),
    dict(normalize_rms_advantage=True), dict(normalize_input=False),
    dict(clip_value=True), "witness", "world"])
def test_which_fused_trainers_take_the_kernels(change, monkeypatch):
    """The default fused trainer takes the kernels (built as on the card,
    then on the CPU the plain twin: one call an epoch); one unsupported
    flag, the witness or a second rank takes the PyTorch path, and no
    launch is counted. Built on the CPU, none takes them."""
    task = tenvs.make_task("hovering", num_envs=N, device="cpu")
    cfg = tppo.PPOConfig(horizon=4, minibatch_size=2048, mini_epochs=1)
    kw = {}
    if change == "witness":
        kw["shares"] = 2
    elif change == "world":
        task.shard = (0, 2 * N)
        kw["group"] = pdist.Group(0, 2, 0, "gloo")
    elif change:
        cfg = dataclasses.replace(cfg, **change)
    assert not fused_ppo.FusedHoveringPPO(task, cfg, **kw).prep_kernels
    calls = _through_the_plain_twin(monkeypatch)
    tr = fused_ppo.FusedHoveringPPO(task, cfg, **kw)
    assert tr.prep_kernels == (change is None)
    assert tr.device == task.device
    if change == "world":
        return          # an epoch needs the second rank
    before = dict(ep.KERNEL.launches)
    ts, m = tr.train_epoch(tr.init(0))
    assert len(calls) == (1 if change is None else 0)
    assert dict(ep.KERNEL.launches) == before
    assert torch.isfinite(m["loss"]) and ts.epoch == 1


def test_the_rollout_hands_its_record_to_the_kernels(monkeypatch):
    """The kernels read the record the epoch's rollout wrote, of which its
    Rollout fields are views, once; without a rollout's record the
    kernels' path refuses to guess one."""
    got = []
    _through_the_plain_twin(monkeypatch)
    plain = ep.epoch_prep
    monkeypatch.setattr(ep, "epoch_prep",
                        lambda rec, *a, **k: got.append(rec) or plain(
                            rec, *a, **k))
    rollout = fused_ppo.FusedHoveringPPO.rollout
    trajs = []
    monkeypatch.setattr(fused_ppo.FusedHoveringPPO, "rollout",
                        lambda self, *a, **k: trajs.append(
                            rollout(self, *a, **k)) or trajs[-1])
    task = tenvs.make_task("hovering", num_envs=N, device="cpu")
    tr = fused_ppo.FusedHoveringPPO(task, tppo.PPOConfig(
        horizon=4, minibatch_size=2048, mini_epochs=1))
    tr.train_epoch(tr.init(0))
    (rec,), (_, traj, last_value, _) = got, trajs[0]
    k = task.num_obs
    assert rec.shape == (4, k + 13, N) and tr._record is None
    for view, row in ((traj.values, k + 5), (traj.rewards, k + 10),
                      (traj.neglogp, k + 4)):
        assert view.data_ptr() == rec[:, row].data_ptr()
    assert traj.obs.data_ptr() == rec.data_ptr()
    with pytest.raises(RuntimeError, match="no rollout record"):
        tr._prepare(tr.init(0), traj, last_value)


@pytest.mark.parametrize("name", ["hovering", "balloon", "tracking"])
def test_fused_epoch_through_the_plain_twin_matches_jax(name, monkeypatch):
    calls = _through_the_plain_twin(monkeypatch)
    if name == "hovering":
        jax_epochs.test_train_epoch_from_jax_matches_jax(monkeypatch)
    else:
        jax_epochs.test_task_train_epoch_from_jax_matches_jax(name,
                                                             monkeypatch)
    assert calls == [1]
