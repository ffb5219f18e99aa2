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
from portbench import program_trace
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
        self.trainer = None


def _finite(m, keys) -> bool:
    return all(math.isfinite(float(m[k])) for k in keys if k in m)


def after(seconds: float):
    """The default stop rule: the first epoch boundary once ``seconds``
    have passed."""
    return lambda elapsed: elapsed >= seconds


def window(trainer, ts, seed: int, seconds: float, stop=None):
    """Train for ``seconds``: (ts, epochs, failed, elapsed s). ``stop``
    (elapsed s -> bool), asked at each epoch boundary, ends the window in
    place of ``after(seconds)``."""
    stop = stop or after(seconds)
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
        if stop(time.perf_counter() - t0):
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
            self._hook_encoder(ts.model)
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

    def _hook_encoder(self, model):
        """``model.encoder`` counted under its name (``model.image_encoder``)
        by ``counts/encoders/<name>.py``; an encoder with no count file is
        counted as nothing."""
        name = getattr(model, "image_encoder", None)
        path = harness.HERE / "counts" / "encoders" / f"{name}.py"
        if name is None or not path.is_file():
            return
        count = harness.load_file(path, f"portbench_encoder_count_{name}")
        enc = model.encoder
        fwd = enc.forward

        def counted(x):
            b, _, w, h = x.shape
            flops = (count.train_flops if torch.is_grad_enabled()
                     else count.forward_flops)(w, h, b)
            self.add(name, work.least_s(flops, count.nbytes(w, h, b),
                                        count.PEAK))
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


def profile(trainer, ts, seconds: float, stop=None):
    """Steady epochs under the profiler with marker spans, until
    ``seconds`` have passed (one epoch at least; ``stop`` as in
    ``window``): (ts, trace.Reading, Work)."""
    stop = stop or after(seconds)
    acct = Work(trainer, ts)
    with trace_mod.Window() as win:
        spans = Spans(trainer, marks=win.marks)
        win.marks(AFTER["update"])
        t0 = time.perf_counter()
        try:
            while True:
                ts, _ = trainer.train_epoch(ts)
                acct.epoch_done()
                if stop(time.perf_counter() - t0):
                    break
        finally:
            spans.remove()
            acct.remove()
    return ts, win.read(), acct


def set_up(params: dict, seed: int, epochs: int, dev, t_start: float,
           plant=None, steps=None):
    """A run's set-up: ``Runner.build`` and ``trainer.init(seed)``
    (``plant(trainer)`` first puts a fault in), then the first ``epochs``
    epochs through ``train_epoch``, ``steps`` (``reference/train``'s
    ``FirstSteps``) watching the first update: (trainer, ts, Snapshot,
    setup_s)."""
    from airgym_tpu_torch.rl import runner as runner_mod
    runner = runner_mod.Runner().load({"params": params})
    _, trainer, _ = runner.build({"seed": seed, "device": str(dev)})
    if plant is not None:
        plant(trainer)
    ts = trainer.init(seed)
    if steps is not None:
        steps.watch(trainer, ts.model)
    try:
        ts, snap = ref_train.snapshot(trainer, ts, epochs,
                                      keep_rollout_on="cpu")
    finally:
        if steps is not None:
            steps.close()
    harness.sync(dev)
    return trainer, ts, snap, time.perf_counter() - t_start


def measure(w: dict, trainer, ts, seed: int, seconds: float, trace: bool,
            setup_s: float, shared=None):
    """The window from ``ts``: (ts, epochs, failed, what it read): the
    end-to-end metrics; traced, the per-layer readers' context (``trace``
    and ``least`` of the profiled stretch, ``spans`` timed over the
    window, ``program`` from the program's own stretch). ``shared``
    (bool -> bool), asked at each epoch boundary of every stretch with
    whether this process would stop, gives the answer all processes
    take (over ranks: rank 0's)."""
    tr = w["traffic_file"]
    shared = shared or (lambda done: done)

    def stop(limit):
        return lambda elapsed: shared(elapsed >= limit)

    if not trace:
        ts, epochs, failed, elapsed = window(trainer, ts, seed, seconds,
                                             stop(seconds))
        rate = epochs * trainer.batch_size / elapsed
        return ts, epochs, failed, {
            m["name"]: {"value": {"setup_s": setup_s}.get(m["name"], rate),
                        "unit": m["unit"]} for m in w["end_to_end"]}
    spans = Spans(trainer, timed=True)
    ts, epochs, failed, _ = window(trainer, ts, seed, seconds, stop(seconds))
    spans.remove()
    ts, reading, acct = profile(trainer, ts, tr["profile_seconds"],
                                stop(tr["profile_seconds"]))
    program = program_trace.train(trainer, stop(program_trace.STRETCH_S))
    return ts, epochs, failed, {"trace": reading, "least": acct.least,
                                "spans": spans, "program": program}


def free(dev) -> None:
    """Return the freed program state's memory before the reference runs
    (the caller has dropped its references)."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run(w: dict, seed: int, seconds: float, trace: bool, t_start: float,
        dev=torch.device("cuda")) -> dict:
    params = w["config_file"]["params"]
    tr = w["traffic_file"]
    trainer, ts, snap, setup_s = set_up(params, seed, tr["checked_epochs"],
                                        dev, t_start)
    ts, epochs, failed, got = measure(w, trainer, ts, seed, seconds, trace,
                                      setup_s)
    info = harness.device_info(w["chips"], dev)
    out = {"attempted": epochs, "failed": failed, "device": info}
    if trace:
        out["metrics"] = harness.per_layer(w, got)
        out["breakdown"] = got["trace"].breakdown()
        info.update(busy_s=got["trace"].busy_s(),
                    window_s=got["trace"].window_s)
    else:
        out["metrics"] = got

    # the program's state is freed before the reference runs
    del ts, trainer, got
    free(dev)
    t_ref = time.perf_counter()
    ref = ref_train.follow(params, seed, tr["checked_epochs"], dev)
    replay = ref_train.replay(params, seed, dev, snap.rollout,
                              snap.last_value)
    out["numbers"] = compare.train_numbers(snap, ref, replay)
    out["look"] = compare.train_look(snap, ref, replay)
    out["look"].update(setup_s=setup_s,
                       reference_s=time.perf_counter() - t_ref)
    return out


def controls(w: dict, seed: int, dev) -> dict:
    """``control.py``'s readings of a training cell on ``seed``: the
    reference put in the program's place in TF32 (the control) and with
    half of each minibatch left out (a fault)."""
    params = w["config_file"]["params"]
    epochs = w["traffic_file"]["checked_epochs"]
    ref = ref_train.follow(params, seed, epochs, dev)
    out = {}
    for name, cand in (
            ("control_tf32", ref_train.follow(params, seed, epochs, dev,
                                              tf32=True)),
            ("fault_half_batch", ref_train.follow(
                params, seed, epochs, dev,
                fault=ref_train.plant_half_batch))):
        replay = ref_train.replay(params, seed, dev, cand.rollout,
                                  cand.last_value)
        out[name] = compare.train_numbers(cand, ref, replay)
        out[f"{name}.look"] = compare.train_look(cand, ref, replay)
    return out
