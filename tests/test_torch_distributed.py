"""Multi-GPU training (parallel/dist.py) on the CPU: the ranks' work is
the one-process run's, as the JAX package's sharded run is its unsharded
one (tests/test_multichip.py).

* A sharded task draws the whole batch's random numbers and keeps its
  rows: the shards' states and outputs are the unsharded task's rows.
* The rank-split fused rollout (its plain version, 2 x 1024 envs) is the
  single call, bit for bit, with each rank's seed offset by its tiles.
* Two gloo ranks, spawned once for the file: the distributed update on
  one fixed dataset, the fused Hovering trainer (2 epochs) and Planning
  with frame dedup (1 epoch) through the runner. Each against the
  one-process run of the same seed within test_multichip's tolerances
  (metrics rtol 2e-3 / atol 2e-4 and parameters atol 5e-4; a camera
  task's metrics rtol 5e-3 / atol 5e-4, as its sharded vision test), the
  ranks bitwise equal, only rank 0 writing, each rank seeded seed +
  rank.
* Each of those runs against its one-process witness (``shares=2``: the
  shares of every minibatch in turn, their gradients added in rank
  order): bit for bit, so that what separates the ranks from the plain
  one-process run is the order of the sums alone."""
import copy
import pathlib

import numpy as np
import pytest
import torch
import yaml

import airgym_tpu_torch.envs as tenvs
from airgym_tpu_torch.models import actor_critic as ac
from airgym_tpu_torch.ops import fused_rollout as fr
from airgym_tpu_torch.parallel import dist as pdist
from airgym_tpu_torch.rl import fused_ppo as tfused
from airgym_tpu_torch.rl import ppo as tppo
from airgym_tpu_torch.rl import runner as trunner

CONFIGS = pathlib.Path(trunner.__file__).resolve().parents[1] / "configs"
CAM = dict(cam_width=24, cam_height=20)
SHARD_TASKS = {"hovering": {}, "balloon": {}, "tracking": {},
               "planning": dict(CAM, num_trees=6), "avoid": CAM,
               "customized": CAM, "maplanning": CAM}


def flat_leaves(x):
    if isinstance(x, torch.Tensor) or x is None or isinstance(
            x, (bool, int, float)):
        return [x]
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in flat_leaves(x[k])]
    return [v for item in x for v in flat_leaves(item)]


def assert_rows(full, parts, n_full):
    """Every leaf of ``full`` with an env-major leading axis equals the
    parts' leaves concatenated; every other leaf is equal on all."""
    leaves = [flat_leaves(p) for p in parts]
    for i, f in enumerate(flat_leaves(full)):
        ps = [lv[i] for lv in leaves]
        if isinstance(f, torch.Tensor) and f.dim() and \
                f.shape[0] % n_full == 0:
            got = torch.cat(ps, 0)
            assert got.shape == f.shape, i
            if f.is_floating_point():
                torch.testing.assert_close(got, f, rtol=0, atol=1e-6)
            else:
                assert torch.equal(got, f), i
        elif isinstance(f, torch.Tensor):
            for p in ps:
                assert torch.equal(p, f), i
        else:
            assert all(p == f for p in ps), i


@pytest.mark.parametrize("name", sorted(SHARD_TASKS))
def test_sharded_task_is_the_batch_rows(name):
    """Two shards of 2 envs against the 4-env task from generators of one
    seed: initial state, then 5 steps (renders included) with the noise
    on; states and outputs are the whole task's rows."""
    n, kw = 4, SHARD_TASKS[name]
    full = tenvs.make_task(name, num_envs=n, device="cpu", **kw)
    parts = []
    for r in range(2):
        t = tenvs.make_task(name, num_envs=n // 2, device="cpu", **kw)
        t.shard = (r * n // 2, n)
        parts.append(t)
    gens = [torch.Generator().manual_seed(7) for _ in range(3)]
    sf = full.initial_state(gens[0])
    sp = [t.initial_state(g) for t, g in zip(parts, gens[1:])]
    assert_rows(sf, sp, n)
    rows = getattr(full, "flat_n", n)
    rng = np.random.default_rng(0)
    for _ in range(5):
        act = torch.from_numpy(rng.uniform(
            -0.3, 0.3, (rows, full.cfg.num_actions)).astype(np.float32))
        sf, of = full.step(sf, act, gens[0])
        outs = []
        for r, t in enumerate(parts):
            h = rows // 2
            s, o = t.step(sp[r], act[r * h:(r + 1) * h], gens[r + 1])
            sp[r] = s
            outs.append(o)
        assert_rows(sf, sp, n)
        assert_rows(of, outs, n)


@pytest.mark.parametrize("name,cls", [
    ("hovering", tfused.FusedHoveringPPO), ("balloon", tfused.FusedBalloonPPO),
    ("tracking", tfused.FusedTrackingPPO)])
def test_rank_split_fused_rollout_is_the_single_call(name, cls):
    """The rollout kernel's plain version over 2 x 1024 envs in one call
    and in two rank blocks with the seeds the ranks' trainers give: the
    same bits (as tests/test_multichip.py's sharded kernel)."""
    n, steps, seed = 2 * fr.TILE, 3, 12345
    task = tenvs.make_task(name, num_envs=n, device="cpu")
    tr = cls(task, tppo.PPOConfig(horizon=steps, minibatch_size=1024))
    ts = tr.init(0)
    pack = fr.pack_policy(ts.model, ts.obs_rms)
    packed = tr._pack_env(ts.env_state)
    kw = dict(obs_noise=True, task=name, motor_alpha=tr._motor_alpha)
    out, rec = fr.rollout_fused_policy(packed, pack, seed, steps, **kw)
    outs, recs = [], []
    for r in range(2):
        t = tenvs.make_task(name, num_envs=fr.TILE, device="cpu")
        t.shard = (r * fr.TILE, n)
        tr_r = cls(t, tppo.PPOConfig(horizon=steps, minibatch_size=1024),
                   group=pdist.Group(rank=r, world=2, local_rank=r,
                                     backend="gloo"))
        sl = slice(r * fr.TILE, (r + 1) * fr.TILE)
        o, c = fr.rollout_fused_policy(packed[:, sl].contiguous(), pack,
                                       tr_r._rank_seed(seed), steps, **kw)
        outs.append(o)
        recs.append(c)
    assert torch.equal(torch.cat(outs, 1), out)
    assert torch.equal(torch.cat(recs, 2), rec)
    assert tr._rank_seed(seed) == seed


def test_trainer_refuses_an_unsharded_task_and_uneven_minibatches():
    t = tenvs.make_task("hovering", num_envs=8, device="cpu")
    g = pdist.Group(rank=1, world=2, local_rank=1, backend="gloo")
    with pytest.raises(ValueError, match="task.shard"):
        tppo.PPO(t, tppo.PPOConfig(horizon=4, minibatch_size=16), group=g)
    t.shard = (8, 16)
    tr = tppo.PPO(t, tppo.PPOConfig(horizon=3, minibatch_size=16), group=g)
    assert tr.batch_size == 48 and tr.num_minibatches == 3
    with pytest.raises(ValueError, match="over 2 ranks"):
        tppo.PPO(t, tppo.PPOConfig(horizon=3, minibatch_size=3), group=g) \
            .train_epoch(None)
    assert pdist.env_shard(16, 1, 2) == (8, 8)
    with pytest.raises(ValueError, match="split evenly"):
        pdist.env_shard(15, 0, 2)


@pytest.mark.parametrize("world", [2, 4])
def test_minibatch_shares_read_their_samples_frames(world):
    """Each rank's share of every minibatch reads, through unique_window
    (frame dedup) and _mb_from_scan_layout (per-step images), the frame
    of each of its samples in the gathered batch."""
    h, n, mb = 8, 16, 32
    frames = torch.arange(3 * n, dtype=torch.float32).reshape(3, n, 1, 1, 1)
    images = torch.arange(h * n, dtype=torch.float32).reshape(h, n, 1, 1, 1)
    for r in range(world):
        t = tenvs.make_task("planning", num_envs=n // world, device="cpu",
                            cam_width=8, cam_height=6, num_trees=2)
        t.shard = (r * n // world, n)
        tr = tppo.PPO(t, tppo.PPOConfig(horizon=h, minibatch_size=mb),
                      group=pdist.Group(r, world, r, "gloo"))
        frame_idx = torch.tensor([k // tr.cam_every for k in range(h)])
        for k in range(tr.num_minibatches):
            start, length = tr._share(k, mb)
            assert length == mb // world
            j = torch.arange(start, start + length)
            img_u, idx = tr.unique_window(frames, frame_idx, k, mb)
            assert torch.equal(img_u[idx], frames[frame_idx[j % h], j // h])
            assert torch.equal(tr._mb_from_scan_layout(images, k, mb),
                               images[j % h, j // h])


# ---------------------------------------------------------------------------
# two gloo ranks, spawned once


UPDATE_ENVS, UPDATE_H = 64, 8
UPDATE_CFG = tppo.PPOConfig(horizon=UPDATE_H, minibatch_size=128,
                            mini_epochs=3)


def fixed_dataset():
    """A batch of 64 envs x 8 steps made from a numpy seed, the
    actions' neglogp taken under the dataset's own mu / sigma."""
    rng = np.random.default_rng(11)
    b = UPDATE_ENVS * UPDATE_H
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    mus = 0.3 * f(b, 4)
    sigmas = torch.full((b, 4), 0.9)
    actions = mus + sigmas * f(b, 4)
    return {"obs": f(b, 18), "actions": actions,
            "neglogp": ac.neglogp(actions, mus, sigmas, torch.log(sigmas)),
            "values": f(b), "returns": f(b), "adv": f(b),
            "mus_init": mus, "sigmas_init": sigmas}


def update_run(group, shares=None):
    """(flat parameters, metrics) of one update on ``fixed_dataset``:
    this rank's share of it in ``group``, or all of it without one (in
    ``shares`` parts as the witness of that many ranks)."""
    n = UPDATE_ENVS // (group.world if group else 1)
    task = tenvs.make_task("hovering", num_envs=n, device="cpu")
    if group is not None:
        task.shard = (group.rank * n, UPDATE_ENVS)
    tr = tppo.PPO(task, UPDATE_CFG, group=group, shares=shares)
    ts = tr.init(3)
    ts, m = tr.update(ts, fixed_dataset())
    params = torch.cat([p.detach().reshape(-1)
                        for p in ts.model.parameters()])
    return params.numpy(), {k: float(v) for k, v in m.items()}


def hover_yaml():
    with open(CONFIGS / "ppo_hovering.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["params"]["config"].update(
        num_actors=2 * fr.TILE, horizon_length=4, minibatch_size=2048,
        mini_epochs=2, max_epochs=2, save_frequency=1, save_best_after=1)
    return cfg


def planning_yaml():
    return {"params": {
        "seed": 9,
        "network": {"mlp": {"units": [32, 32], "activation": "elu"},
                    "cnn": {"output_dim": 8}},
        "config": {"env_name": "planning", "num_actors": 8,
                   "horizon_length": 8, "minibatch_size": 32,
                   "mini_epochs": 2, "max_epochs": 1, "save_frequency": 1,
                   "save_best_after": 1,
                   "env_config": dict(CAM, num_trees=6)}}}


def rank_job(group, root):
    """Everything the two ranks run in the one spawn."""
    return {"update": update_run(group),
            "hovering": pdist.train_report(
                group, hover_yaml(), {"device": "cpu",
                                      "run_root": f"{root}/hovering"}),
            "planning": pdist.train_report(
                group, planning_yaml(), {"device": "cpu",
                                         "run_root": f"{root}/planning"})}


def one_process(yaml_cfg, run_root, shares=None):
    ts, info = trunner.Runner().load(yaml_cfg).run_train(
        {"device": "cpu", "run_root": run_root, "shares": shares})
    params = torch.cat([p.detach().reshape(-1)
                        for p in ts.model.parameters()])
    return params.numpy(), info["history"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("ranks")
    return root, pdist.spawn(2, rank_job, (str(root),), backend="gloo",
                             timeout=600)


def test_distributed_update_matches_one_process(ranks):
    _, reports = ranks
    (p0, m0), (p1, m1) = reports[0]["update"], reports[1]["update"]
    assert np.array_equal(p0, p1) and m0 == m1
    p_ref, m_ref = update_run(None)
    rtol, atol, param_atol = pdist.VECTOR_TOL
    np.testing.assert_allclose(p0, p_ref, rtol=0, atol=param_atol)
    for k, v in m_ref.items():
        np.testing.assert_allclose(m0[k], v, rtol=rtol, atol=atol,
                                   err_msg=k)


def test_two_rank_fused_hovering_matches_one_process(ranks, tmp_path):
    """The fused trainer's rollout kernel on each rank (plain version
    here), the plain distributed update; the one-process run takes the
    plain update too (the witness of one rank, shares=1), so the two
    runs differ only in the ranks' reduction order."""
    root, reports = ranks
    ref = one_process(hover_yaml(), str(tmp_path), shares=1)
    hov = [r["hovering"] for r in reports]
    pdist.check_reports(hov, f"{root}/hovering", ref)
    assert len(hov[0]["history"]) == 2


def test_two_rank_planning_matches_one_process(ranks, tmp_path):
    """Planning with frame dedup: each rank's share of a minibatch reads
    its unique frames from the gathered batch (unique_window on a
    sub-span)."""
    root, reports = ranks
    ref = one_process(planning_yaml(), str(tmp_path))
    pdist.check_reports([r["planning"] for r in reports],
                        f"{root}/planning", ref, pdist.VISION_TOL)


def test_rank0_gating_and_seed_plus_rank(ranks):
    """Only rank 0 writes the run directory and the checkpoints; rank r's
    global torch RNG holds seed + r (torch.initial_seed() in the rank's
    process); the metrics of both ranks are the same."""
    root, reports = ranks
    for task in ("hovering", "planning"):
        r0, r1 = (r[task] for r in reports)
        assert r0["checkpoint"] is not None and r0["run_dir"] is not None
        assert r1["checkpoint"] is None and r1["run_dir"] is None
        assert (r0["torch_seed"], r1["torch_seed"]) == (
            r0["seed"], r0["seed"] + 1)
        assert (r0["world"], r0["backend"]) == (2, "gloo")
        bad = copy.deepcopy(reports)
        bad[1][task]["checkpoint"] = "written"
        with pytest.raises(RuntimeError, match="want rank 0"):
            pdist.check_reports([r[task] for r in bad], f"{root}/{task}")
        bad = copy.deepcopy(reports)
        bad[1][task]["torch_seed"] = r0["seed"]
        with pytest.raises(RuntimeError, match="want seed \\+ rank"):
            pdist.check_reports([r[task] for r in bad], f"{root}/{task}")


@pytest.mark.parametrize("job", ["update", "hovering", "planning"])
def test_two_ranks_are_their_witness_bit_for_bit(ranks, tmp_path, job):
    """The one-process witness of two ranks (shares=2) adds the two
    shares' gradients as the all-reduce does: the update on the fixed
    dataset, the fused Hovering run and the Planning run equal the ranks'
    bit for bit, parameters and metrics."""
    root, reports = ranks
    if job == "update":
        (p0, m0), (p_w, m_w) = reports[0]["update"], update_run(None, 2)
        assert np.array_equal(p0, p_w) and m0 == m_w
        return
    yaml_cfg = hover_yaml() if job == "hovering" else planning_yaml()
    witness = one_process(yaml_cfg, str(tmp_path), shares=2)
    pdist.check_reports([r[job] for r in reports], f"{root}/{job}",
                        witness, pdist.BITWISE)
