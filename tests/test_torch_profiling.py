"""The port's program spans (rl/profiling.py) and the benchmark's reading
of them (portbench/program_trace.py): the tracer's records, the split of
idle device time, launches and syncs by span on synthetic events, the
span trees of both trainers' epochs, and an epoch traced equal to the
bit to one untraced."""
import contextlib
import time

import pytest
import torch

import airgym_tpu_torch.envs as tenvs
from airgym_tpu_torch.rl import fused_ppo
from airgym_tpu_torch.rl import ppo as tppo
from airgym_tpu_torch.rl import profiling
from portbench import program_trace as pt


@pytest.fixture
def tracing():
    profiling.start()
    try:
        yield
    finally:
        profiling.stop()


def tree(records):
    """(name, parent name, root id) of each record."""
    return [(r.name, records[r.parent].name if r.parent >= 0 else None,
             r.root_id) for r in records]


def test_off_records_nothing_and_returns_the_shared_null_context():
    profiling.start()
    profiling.stop()
    a, b = profiling.span("a"), profiling.span("b", 3)
    assert a is b
    assert isinstance(a, contextlib.nullcontext)
    with a:
        pass
    assert profiling.stop() == []


def test_nesting_parents_and_root_ids(tracing):
    with profiling.span("epoch", 7):
        with profiling.span("rollout"):
            with profiling.span("bookkeeping"):
                pass
        with profiling.span("update"):
            pass
    with profiling.span("call"):
        with profiling.span("inner"):
            pass
    with profiling.span("call"):
        pass
    rec = profiling.stop()
    assert tree(rec) == [("epoch", None, 7), ("rollout", "epoch", 7),
                         ("bookkeeping", "rollout", 7),
                         ("update", "epoch", 7), ("call", None, 1),
                         ("inner", "call", 1), ("call", None, 2)]
    for r in rec:
        assert r.end_ns is not None and r.end_ns >= r.start_ns
    assert rec[0].start_ns <= rec[1].start_ns <= rec[2].end_ns \
        <= rec[1].end_ns <= rec[3].start_ns <= rec[0].end_ns


def test_an_exception_closes_the_span(tracing):
    with pytest.raises(ValueError):
        with profiling.span("outer", 0):
            with profiling.span("inner"):
                raise ValueError("x")
    with profiling.span("next"):
        pass
    rec = profiling.stop()
    assert tree(rec) == [("outer", None, 0), ("inner", "outer", 0),
                         ("next", None, 1)]
    assert all(r.end_ns is not None for r in rec)


def test_spans_share_the_profilers_clock(tracing):
    """A span and a profiler event opened together sit together on the
    trace's timeline: kineto's host clock is Unix time, as time.time_ns()
    is (another clock would read hours or years apart; the bound leaves
    room for a loaded host)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("x"):
            with torch.profiler.record_function("x_event"):
                time.sleep(0.01)
    rec = profiling.stop()
    ev = [e for e in prof.events() if e.name == "x_event"][0]
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    at_us = (rec[0].start_ns - start_ns) * 1e-3
    assert abs(ev.time_range.start - at_us) < 5e5
    assert abs(ev.time_range.end - (rec[0].end_ns - start_ns) * 1e-3) < 5e5


# -- the reading, on synthetic events (us after the trace's start 0) --------

def R(name, parent, start, end, root_id=0):
    return profiling.Record(name, parent, root_id, int(start * 1e3),
                            int(end * 1e3))


EPOCH = [R("epoch", -1, 0, 100), R("rollout", 0, 0, 40),
         R("bookkeeping", 1, 20, 40), R("gae", 0, 40, 60),
         R("update", 0, 60, 100)]


def test_an_idle_gap_splits_across_two_spans():
    # device busy 0-10, 30-50 and 90-95: gaps 10-30 (rollout 10-20,
    # bookkeeping 20-30) and 50-90 (gae 50-60, update 60-90)
    p = pt.Program(EPOCH, 0, [(0, 10), (30, 50), (90, 95)], [])
    assert p.roots == 1
    assert p.idle_us["bookkeeping"] == pytest.approx(10)
    assert p.idle_us["rollout"] == pytest.approx(20)      # its subtree
    assert p.idle_us["gae"] == pytest.approx(10)
    assert p.idle_us["update"] == pytest.approx(30)
    assert p.idle_us["epoch"] == pytest.approx(60)
    assert p.idle_ms("rollout") == pytest.approx(0.020)
    assert "outside" not in p.idle_us


def test_an_idle_gap_with_no_span_open_goes_outside():
    recs = EPOCH + [R("epoch", -1, 200, 300, 1)]
    # gaps 95-140 (epoch 0 ends at 100: 5 in update, 40 outside) and
    # 160-220 (40 outside, 20 in epoch 1); events come in any order
    p = pt.Program(recs, 0, [(0, 95), (150, 160), (140, 150), (220, 300)],
                   [])
    assert p.roots == 2
    assert p.idle_us["outside"] == pytest.approx(80)
    assert p.idle_us["update"] == pytest.approx(5)
    assert p.idle_us["epoch"] == pytest.approx(25)
    assert p.idle_ms("epoch") == pytest.approx(0.0125)   # per root span


def test_launches_and_syncs_per_span():
    runtime = [(5, "cudaLaunchKernel"), (25, "cudaLaunchKernel"),
               (26, "cudaLaunchCooperativeKernel"),
               (45, "cudaStreamSynchronize"), (46, "cudaMemcpyAsync"),
               (47, "cudaStreamIsCapturing"), (70, "cuLaunchKernel"),
               (75, "cudaMemcpy"), (150, "cudaLaunchKernel"),
               (151, "cudaDeviceSynchronize")]
    p = pt.Program(EPOCH, 0, [], runtime)
    assert p.launch_n == {"rollout": 3, "bookkeeping": 2, "epoch": 4,
                          "update": 1, "outside": 1}
    assert p.sync_n == {"gae": 1, "update": 1, "epoch": 2, "outside": 1}
    assert p.launches("epoch") == 4 and p.syncs("bookkeeping") == 0.0
    assert p.counts == {"epoch": 1, "rollout": 1, "bookkeeping": 1,
                        "gae": 1, "update": 1}


def test_no_root_span_reads_nothing():
    p = pt.Program([], 0, [(0, 1), (5, 6)], [(2, "cudaLaunchKernel")])
    assert p.idle_ms("epoch") is None and p.launches("epoch") is None
    assert p.idle_us == {"outside": pytest.approx(4)}


def test_readers_read_nothing_without_a_card_or_a_program_reading():
    from portbench import harness
    if torch.cuda.is_available():
        pytest.skip("on the card the readers make their own stretch")
    for name in ("gae_idle_ms.state", "launches_per_adam_step.vision",
                 "syncs_per_call.sim"):
        assert harness.reader(name)({"spans": None}) is None


def test_encode_hit_share_reads_hits_over_minibatches():
    """``encode_hit_share.resnet``: 4 ``encode_hit`` spans in 5
    minibatches read 80%; none, or no program reading, read nothing."""
    from portbench import harness
    read = harness.reader("encode_hit_share.resnet")
    recs = [R("epoch", -1, 0, 100)]
    for i in range(5):
        mb = len(recs)
        recs += [R("minibatch", 0, 20 * i, 20 * i + 15),
                 R("loss", mb, 20 * i, 20 * i + 5)]
        if i:
            recs.append(R("encode_hit", mb + 1, 20 * i + 1, 20 * i + 2))
    assert read({"program": pt.Program(recs, 0, [], [])}) == 80.0
    misses = [r for r in recs if r.name != "encode_hit"]
    assert read({"program": pt.Program(misses, 0, [], [])}) is None
    assert read({"program": None}) is None


# -- the trainers' span trees -----------------------------------------------

def _hovering():
    task = tenvs.make_task("hovering", num_envs=1024, device="cpu")
    cfg = tppo.PPOConfig(horizon=3, minibatch_size=1024, mini_epochs=2)
    return fused_ppo.FusedHoveringPPO(task, cfg)


def _planning(image_encoder="cnn"):
    task = tenvs.make_task("planning", num_envs=8, device="cpu",
                           cam_width=32, cam_height=16)
    cfg = tppo.PPOConfig(horizon=8, minibatch_size=32, mini_epochs=2)
    return tppo.PPO(task, cfg,
                    network_kw={"image_encoder": image_encoder})


def _planning_resnet():
    return _planning("resnet")


EPOCH_TREE = [("epoch", None), ("rollout", "epoch"), ("gae", "epoch"),
              ("stats", "epoch"), ("dataset", "epoch"), ("update", "epoch")]


def test_span_tree_of_the_fused_hovering_epoch(tracing):
    tr = _hovering()
    ts = tr.init(3)
    ts, _ = tr.train_epoch(ts)
    rec = profiling.stop()
    got = [(n, p) for n, p, _ in tree(rec)]
    assert got == EPOCH_TREE[:2] + [("bookkeeping", "rollout")] \
        + EPOCH_TREE[2:]
    assert {r.root_id for r in rec} == {0}


def test_span_tree_of_the_plain_image_epoch_one_minibatch_per_step(
        tracing):
    tr = _planning()
    ts = tr.init(3)
    ts, _ = tr.train_epoch(ts)
    ts, _ = tr.train_epoch(ts)
    rec = profiling.stop()
    steps = tr.cfg.mini_epochs * tr.num_minibatches
    assert steps == 4
    # ``encode`` (the encoder's call) in the rollout: the first frame's
    # features, each of the two renders' and the bootstrap value's; and
    # once in each minibatch's loss, over the window's unique frames
    one = EPOCH_TREE[:2] + [("encode", "rollout")] * 4 + EPOCH_TREE[2:] \
        + [("minibatch", "update"), ("loss", "minibatch"),
           ("encode", "loss"), ("backward", "minibatch"),
           ("adam", "minibatch")] * steps
    got = [(n, p) for n, p, _ in tree(rec)]
    assert got == one + one
    assert [r.root_id for r in rec] == [0] * len(one) + [1] * len(one)


@pytest.mark.parametrize("make", [_hovering, _planning, _planning_resnet],
                         ids=["fused_hovering", "plain_image",
                              "plain_image_resnet"])
def test_an_epoch_traced_equals_one_untraced_to_the_bit(make):
    tr = make()
    out = []
    for traced in (False, True):
        ts = tr.init(5)
        if traced:
            profiling.start()
        try:
            ts, m = tr.train_epoch(ts)
        finally:
            rec = profiling.stop()
        assert bool(rec) == traced
        out.append((ts, m))
    (a, ma), (b, mb) = out
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for x, y in ((a.lr, b.lr), (a.ep_return, b.ep_return),
                 (a.adam["count"], b.adam["count"])):
        assert torch.equal(x, y)
    assert a.epoch == b.epoch == 1


@pytest.mark.parametrize("image_encoder", ["resnet", "vae", "cnn"])
def test_a_frozen_encoder_runs_once_a_window_in_an_update(image_encoder,
                                                          tracing):
    """In one update at 2 mini-epochs a frozen encoder (ResNet-18 but its
    ``fc``, the VAE whole) runs once per minibatch window and its head
    alone in the later mini-epoch (``encode_hit``); the CNN, which
    trains, runs in every minibatch."""
    tr = _planning(image_encoder)
    ts = tr.init(3)
    enc, update = ts.model.encoder, tr.update
    calls = []
    fwd = enc.forward
    enc.forward = lambda x: calls.append(x.shape[0]) or fwd(x)

    def counted(ts, dataset):
        calls.clear()                 # the rollout's calls
        return update(ts, dataset)
    tr.update = counted
    tr.train_epoch(ts)
    rec = profiling.stop()
    nmb, epochs = tr.num_minibatches, tr.cfg.mini_epochs
    assert nmb == 2 and epochs == 2
    hits = [(n, p) for n, p, _ in tree(rec) if n == "encode_hit"]
    frozen = image_encoder != "cnn"
    assert ts.model.frozen_head() is (enc.head if frozen else None)
    assert len(calls) == (nmb if frozen else epochs * nmb)
    assert hits == [("encode_hit", "loss")] * ((epochs - 1) * nmb
                                               if frozen else 0)
