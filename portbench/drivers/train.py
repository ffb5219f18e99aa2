"""Traffic of kind ``train``: a PPO job as the runner builds it from the
frozen YAML params.

Set-up: ``Runner.build`` and ``trainer.init(seed)``, then the first
``checked_epochs`` epochs through ``trainer.train_epoch``, the window's
own call (they compile and warm every shape the window uses). The window
then continues the same training state: ``train_epoch`` back to back,
``trainer.init(seed + k)`` each time the job reaches the YAML's
``max_epochs`` (users run whole jobs), a sync and a read of the logged
scalars every ``max(1, max_epochs // 50)`` epochs, as the runner's log
line; it ends at the first epoch boundary after ``--seconds`` and the
rate divides all frames trained on by all the time elapsed.
"""
from __future__ import annotations

import gc
import math
import time

import torch

from portbench import harness
from portbench import trace as trace_mod
from portbench.counts import work
from portbench.reference import compare
from portbench.reference import train as ref_train


# what the host does between the end of a span and the next span
AFTER = {"rollout": "GAE, running stats, dataset",
         "update": "epoch metrics, next epoch"}


class Spans:
    """The benchmark's spans around ``trainer.rollout`` and
    ``trainer.update``: a sync either side and the host clock
    (``timed``), or a marker kernel at each boundary (``marks``)."""

    def __init__(self, trainer, timed: bool = False, marks=None):
        self.total = {"rollout": 0.0, "update": 0.0}
        self.count = {"rollout": 0, "update": 0}
        self.trainer = trainer
        for name in ("rollout", "update"):
            setattr(trainer, name, self._wrap(name, getattr(trainer, name),
                                              timed, marks))

    def _wrap(self, name, fn, timed, marks):
        def wrapped(*a, **k):
            if marks is not None:
                marks(name)
            if timed:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            out = fn(*a, **k)
            if timed:
                torch.cuda.synchronize()
                self.total[name] += time.perf_counter() - t0
                self.count[name] += 1
            if marks is not None:
                marks(AFTER[name])
            return out
        return wrapped

    def remove(self):
        for name in ("rollout", "update"):
            delattr(self.trainer, name)


def _finite(m, keys) -> bool:
    return all(math.isfinite(float(m[k])) for k in keys if k in m)


def window(trainer, ts, seed: int, seconds: float):
    """Train for ``seconds``: (ts, epochs, failed, elapsed s)."""
    from airgym_tpu_torch.rl import runner as runner_mod
    keys = runner_mod.LOGGED
    cfg = trainer.cfg
    sync_every = max(1, cfg.max_epochs // 50)
    epochs = failed = restarts = 0
    dev = trainer.device
    harness.sync(dev)
    t0 = time.perf_counter()
    while True:
        ts, m = trainer.train_epoch(ts)
        epochs += 1
        last = m
        if epochs % sync_every == 0:
            harness.sync(dev)
            failed += not _finite(m, keys)
            last = None
        if ts.epoch >= cfg.max_epochs:
            restarts += 1
            ts = trainer.init(seed + restarts)
        if time.perf_counter() - t0 >= seconds:
            break
    harness.sync(dev)
    if last is not None:
        failed += not _finite(last, keys)
    return ts, epochs, failed, time.perf_counter() - t0


class Work:
    """The counted work of a profiled stretch, by layer: least seconds at
    each part's peak (``counts/work.py``), from what the program was
    given and launched in that stretch."""

    def __init__(self, trainer, ts):
        self.trainer, self.ts = trainer, ts
        self.least = {}          # layer -> least seconds in the stretch
        self._undo = []
        cfg = trainer.cfg
        n = trainer.num_envs
        self.fused = hasattr(trainer, "fused_task")
        self.in_dim = ts.model.actor_mlp.layers[0].in_features
        if self.fused:
            self.rollout_s = work.least_s(*work.rollout_work(
                trainer.fused_task, n, cfg.horizon))
            self.update_s = work.least_s(*work.update_work(
                self.in_dim, trainer.batch_size, cfg.mini_epochs))
        else:
            self._hook_render()
            self._hook_cnn(ts.model)
            self._hook_mlp(ts.model)

    def add(self, layer, seconds):
        self.least[layer] = self.least.get(layer, 0.0) + seconds

    def epoch_done(self):
        if self.fused:
            self.add("rollout_kernel", self.rollout_s)
            self.add("update_kernel", self.update_s)

    def _hook_render(self):
        from airgym_tpu_torch.render import raycast
        orig = raycast.render_process_packed

        def counted(inp):
            self.add("render_kernel", work.least_s(*work.render_work(inp)))
            return orig(inp)
        raycast.render_process_packed = counted
        self._undo.append(lambda: setattr(raycast, "render_process_packed",
                                          orig))

    def _hook_cnn(self, model):
        enc = model.actor_cnn
        fwd = enc.forward

        def counted(x):
            b, _, w, h = x.shape
            flops = (work.cnn_train_flops if torch.is_grad_enabled()
                     else work.cnn_forward_flops)(w, h, b)
            self.add("cnn", work.least_s(flops, 2.0 * b * w * h,
                                         work.PEAK_BF16))
            return fwd(x)
        enc.forward = counted
        self._undo.append(lambda: delattr(enc, "forward"))

    def _hook_mlp(self, model):
        mlp = model.actor_mlp
        fwd = mlp.forward

        def counted(x):
            rows = x.reshape(-1, x.shape[-1]).shape[0]
            mult = 3.0 if torch.is_grad_enabled() else 1.0
            self.add("mlp", work.least_s(
                mult * 2.0 * work.mlp_macs(self.in_dim) * rows, 0.0))
            return fwd(x)
        mlp.forward = counted
        self._undo.append(lambda: delattr(mlp, "forward"))

    def remove(self):
        for undo in self._undo:
            undo()


def profile(trainer, ts, seconds: float):
    """Steady epochs under the profiler with marker spans, until
    ``seconds`` have passed (one epoch at least): (ts, trace.Reading,
    Work)."""
    acct = Work(trainer, ts)
    with trace_mod.Window() as win:
        spans = Spans(trainer, marks=win.marks)
        win.marks(AFTER["update"])
        epochs, t0 = 0, time.perf_counter()
        try:
            while epochs == 0 or time.perf_counter() - t0 < seconds:
                ts, _ = trainer.train_epoch(ts)
                acct.epoch_done()
                epochs += 1
        finally:
            spans.remove()
            acct.remove()
    return ts, win.read(), acct


def run(w: dict, seed: int, seconds: float, trace: bool, t_start: float,
        dev=torch.device("cuda")) -> dict:
    from airgym_tpu_torch.rl import runner as runner_mod
    params = w["config_file"]["params"]
    tr = w["traffic_file"]
    runner = runner_mod.Runner().load({"params": params})
    _, trainer, _ = runner.build({"seed": seed, "device": str(dev)})
    ts = trainer.init(seed)
    ts, snap = ref_train.snapshot(trainer, ts, tr["checked_epochs"],
                                  keep_rollout_on="cpu")
    harness.sync(dev)
    setup_s = time.perf_counter() - t_start

    out = {"metrics": {}}
    if trace:
        spans = Spans(trainer, timed=True)
        ts, epochs, failed, _ = window(trainer, ts, seed, seconds)
        spans.remove()
        ts, reading, acct = profile(trainer, ts, tr["profile_seconds"])
        ctx = {"trace": reading, "least": acct.least, "spans": spans}
        out["metrics"] = harness.per_layer(w, ctx)
        out["breakdown"] = reading.breakdown()
        info = harness.device_info(w["chips"], dev)
        info["busy_s"] = reading.busy_s()
        info["window_s"] = reading.window_s
    else:
        ts, epochs, failed, elapsed = window(trainer, ts, seed, seconds)
        rate = epochs * trainer.batch_size / elapsed
        for m in w["end_to_end"]:
            value = {"setup_s": setup_s}.get(m["name"], rate)
            out["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        info = harness.device_info(w["chips"], dev)
    out.update(attempted=epochs, failed=failed, device=info)

    # the program's state is freed before the reference runs
    del ts, trainer, runner
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = ref_train.follow(params, seed, tr["checked_epochs"], dev)
    replay = ref_train.replay(params, seed, dev, snap.rollout,
                              snap.last_value)
    out["numbers"] = compare.train_numbers(snap, ref, replay)
    out["look"] = compare.train_look(snap, ref, replay)
    out["look"].update(setup_s=setup_s,
                       reference_s=time.perf_counter() - t_ref)
    return out
