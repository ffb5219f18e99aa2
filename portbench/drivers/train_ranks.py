"""Traffic of kind ``train_ranks``: the ``train`` job data-parallel over
``ranks`` processes, one card each, as ``torchrun`` runs the port.

The configuration is the reference's per-rank YAML; the port's runner
counts envs over all ranks, so each number the traffic lists under
``per_rank`` (envs, minibatch) is multiplied by ``ranks`` for it.

This process is rank 0. It starts ranks 1 .. R-1 as processes of their
own (this file, the run's job on standard input) with torchrun's
``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT``, and every rank joins the process group with the
traffic's collective timeout; the runner's ``pdist.init_from_env`` finds
that group. Each rank runs the ``train`` driver's steps: set-up
(``train.set_up``), the window and, traced, the profiled stretch and the
program's own (``train.measure``); at each epoch boundary of each, rank
0 decides whether to stop and broadcasts it, so that all ranks stop at
the same epoch. The rate is all ranks' env-steps over rank 0's window.
Traced, every rank reads its NCCL kernels' time, and rank 0 the
per-layer metrics. A rank other than 0 prints nothing on standard
output.

Correctness: once the program's state is freed, rank 0 gathers each
rank's first rollout and its first update's steps as Adam got them
(``reference/train.FirstSteps``, over the first mini-epoch); the plain
reference rolls the unsharded batch out from the seed and replays its
one-process first update on the gathered rollout to the same step
(``compare.ranks_numbers``).

A rank that exits with an error, or a run that passes ``seconds`` +
``deadline_s``, ends every rank: rank 0 watches its children and the
clock and kills them all; a child ends itself once rank 0 is gone. The
run then exits non-zero with no result.
"""
from __future__ import annotations

import datetime
import json
import os
import signal
import socket
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

if __name__ == "__main__":          # a rank other than 0
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402
import torch.distributed as tdist  # noqa: E402

from portbench import harness  # noqa: E402
from portbench import trace as trace_mod  # noqa: E402
from portbench.drivers import train  # noqa: E402
from portbench.reference import compare  # noqa: E402
from portbench.reference import train as ref_train  # noqa: E402
from portbench.reference.plain.rl import ppo as ref_ppo  # noqa: E402

# exit code of a run whose ranks the watch ended
ENDED = 5
# the first update's Adam steps the comparison follows: the order in
# which the ranks' shares add is seeded rounding that Adam amplifies
# step by step (the witness in ``controls``: by step 12 it reads within
# 3x of the TF32 control, by step 48 the control's size)
STEPS = 3


# ---- faults planted in the program (control.py --fault-seeds, tests) ----

def _state_unchanged(trainer, rank, world, tr):
    """Every rank's update returns its state unchanged."""
    trainer.update = lambda ts, dataset: (ts, {
        k: torch.zeros((), device=trainer.device) for k in ref_ppo.METRICS})


def _half_batch(trainer, rank, world, tr):
    """Each rank's loss is the mean over the first half of its share."""
    ref_train.plant_half_batch(trainer)


def _skip_allreduce(trainer, rank, world, tr):
    """The exchange left out on the last rank: it joins each gradient
    all-reduce and keeps its own share's gradient."""
    if rank == world - 1:
        reduce = trainer._all_reduce

        def own(grads, row):
            reduce(grads, row)
            return grads, row
        trainer._all_reduce = own


def _wrong_rows(trainer, rank, world, tr):
    """Rank 0 steps the next rank's block of envs in place of its own."""
    if rank == 0:
        first, total = trainer.task.shard
        trainer.task.shard = (first + total // world, total)


def _at_window(act):
    """A fault of rank 1 at the window's first epoch boundary."""
    def plant(trainer, rank, world, tr):
        if rank != 1:
            return
        epoch, calls = trainer.train_epoch, [0]

        def once_more(ts, *a, **k):
            calls[0] += 1
            if calls[0] > tr["checked_epochs"]:
                act()
            return epoch(ts, *a, **k)
        trainer.train_epoch = once_more
    return plant


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "skip_allreduce": _skip_allreduce, "wrong_rows": _wrong_rows,
          "rank_dies": _at_window(
              lambda: os.kill(os.getpid(), signal.SIGKILL)),
          "rank_hangs": _at_window(lambda: time.sleep(1e6))}
# the faults that control.py reads on the card (a state left unchanged
# reads 1 by the change's measure and needs no run)
READ = ("half_batch", "skip_allreduce", "wrong_rows")


# ---- the ranks ------------------------------------------------------------

def params_for(w: dict) -> dict:
    """The configuration's params with the ``per_rank`` numbers over all
    ranks, as the port's runner counts them."""
    tr = w["traffic_file"]
    params = json.loads(json.dumps(w["config_file"]["params"]))
    for key in tr["per_rank"]:
        params["config"][key] = int(params["config"][key]) * tr["ranks"]
    return params


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _Watch(threading.Thread):
    """Rank 0's watch over the other ranks: a rank that exits with an
    error, or the run passing its deadline, ends every rank and this
    process with no result."""

    def __init__(self, procs, deadline_s: float):
        super().__init__(daemon=True)
        self.procs, self.deadline_s = procs, deadline_s
        self.deadline = time.monotonic() + deadline_s
        self.done = threading.Event()

    def run(self):
        while not self.done.wait(0.2):
            for r, p in enumerate(self.procs, 1):
                if p.poll() not in (None, 0):
                    self._end(f"rank {r} exited with code {p.returncode}")
            if time.monotonic() > self.deadline:
                self._end(f"the run passed its deadline of "
                          f"{self.deadline_s:g} s")

    def _end(self, why: str):
        _kill(self.procs)
        print(f"train_ranks: {why}; every rank ended, no result",
              file=sys.stderr, flush=True)
        os._exit(ENDED)

    def finish(self, grace: float) -> list:
        """Stop watching, wait up to ``grace`` s for the ranks to end,
        kill any left; their exit codes."""
        self.done.set()
        self.join()
        end = time.monotonic() + grace
        for p in self.procs:
            try:
                p.wait(max(0.0, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
        _kill(self.procs)
        return [p.returncode for p in self.procs]


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def session(w: dict, jobs: list, seconds: float, trace: bool,
            t_start: float, dev, on_result=None) -> list:
    """Run ``jobs`` ([seed, fault or None]) one after another on all
    ranks in one process group; rank 0's result of each (also handed to
    ``on_result`` as it comes)."""
    tr = w["traffic_file"]
    world = tr["ranks"]
    if dev.type == "cuda" and torch.cuda.device_count() < world:
        raise SystemExit(f"the cell needs {world} CUDA devices, "
                         f"{torch.cuda.device_count()} visible")
    port = _free_port()
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE=str(world))
    job = json.dumps({"w": w, "jobs": jobs, "seconds": seconds,
                      "trace": trace, "device": dev.type}).encode()
    procs = []
    watch = _Watch(procs, len(jobs) * (seconds + tr["deadline_s"]))
    watch.start()
    try:
        for r in range(1, world):
            procs.append(subprocess.Popen(
                [sys.executable, __file__], stdin=subprocess.PIPE,
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r))))
            procs[-1].stdin.write(job)
            procs[-1].stdin.close()
        out = _worker(0, world, w, jobs, seconds, trace, dev, t_start,
                      f"tcp://localhost:{port}", on_result)
    except BaseException:
        watch.finish(0.0)
        raise
    codes = watch.finish(60.0)
    if any(codes):
        raise SystemExit(f"ranks 1-{world - 1} exited with codes {codes}")
    return out


def run(w: dict, seed: int, seconds: float, trace: bool, t_start: float,
        dev=torch.device("cuda"), fault=None) -> dict:
    return session(w, [[seed, fault]], seconds, trace, t_start, dev)[0]


def _worker(rank, world, w, jobs, seconds, trace, dev, t_start,
            init_method, on_result=None) -> list:
    tr = w["traffic_file"]
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    tdist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=tr["collective_timeout_s"]))
    # between two jobs the other ranks wait for rank 0's reference, longer
    # than a collective may take: at a barrier bounded by the deadline
    between = tdist.new_group(backend="gloo", timeout=datetime.timedelta(
        seconds=seconds + tr["deadline_s"])) if len(jobs) > 1 else None
    try:
        out = []
        for k, (seed, fault) in enumerate(jobs):
            res = _job(rank, world, w, seed, fault, seconds, trace, dev,
                       t_start if k == 0 else time.perf_counter())
            out.append(res)
            if on_result is not None and res is not None:
                on_result(k, res)
            if k + 1 < len(jobs):
                tdist.barrier(group=between)
        return out
    finally:
        tdist.destroy_process_group()


def _decides(dev):
    """Rank 0's answer on every rank (a broadcast at an epoch boundary)."""
    def decide(mine: bool) -> bool:
        flag = torch.tensor([int(mine)], device=dev)
        tdist.broadcast(flag, 0)
        return bool(flag.item())
    return decide


def _peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _exchange(reading) -> list:
    """NCCL's kernels' union seconds in a rank's profiled stretch, and the
    stretch's seconds."""
    nccl = [e for e in reading.events if "nccl" in e[2].lower()]
    return [trace_mod.union_s(nccl), reading.window_s]


def _job(rank, world, w, seed, fault, seconds, trace, dev, t_start):
    """One run on this rank: rank 0's result, None on the others."""
    from airgym_tpu_torch.rl import ppo as port_ppo
    tr = w["traffic_file"]
    params = params_for(w)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    plant = None if fault is None else (
        lambda t: FAULTS[fault](t, rank, world, tr))
    steps = ref_train.FirstSteps(port_ppo, (STEPS,))
    trainer, ts, snap, setup_s = train.set_up(
        params, seed, tr["checked_epochs"], dev, t_start, plant, steps)
    ts, epochs, failed, got = train.measure(w, trainer, ts, seed, seconds,
                                            trace, setup_s, _decides(dev))
    mine = {"epochs": epochs, "epoch": ts.epoch, "peak": _peak(dev),
            "steps": steps.reading()[0]}
    if trace:
        mine.update(busy_s=got["trace"].busy_s(),
                    exchange=_exchange(got["trace"]))

    # the program's state is freed before the reference runs
    del ts, trainer
    train.free(dev)
    everyone = [None] * world
    tdist.all_gather_object(everyone, mine)
    rollout, last_value = _gathered(snap.rollout, snap.last_value, dev,
                                    world)
    del snap
    if rank != 0:
        return None

    out = {"attempted": epochs, "failed": failed,
           "device": _device(dev, world, everyone)}
    if trace:
        got["exchange"] = [m["exchange"] for m in everyone]
        out["metrics"] = harness.per_layer(w, got)
        out["breakdown"] = got["trace"].breakdown()
        out["device"].update(
            busy_s=statistics.fmean(m["busy_s"] for m in everyone),
            window_s=got["trace"].window_s)
    else:
        out["metrics"] = got
    t_ref = time.perf_counter()
    ref_rollout, ref_steps = _reference(params, seed, dev, rollout,
                                        last_value, world)
    prog_steps = [m["steps"] for m in everyone]
    out["numbers"] = compare.ranks_numbers(rollout, ref_rollout, prog_steps,
                                           ref_steps)
    out["look"] = compare.ranks_look(rollout, ref_rollout, prog_steps,
                                     ref_steps)
    out["look"].update(setup_s=setup_s,
                       reference_s=time.perf_counter() - t_ref,
                       epochs_by_rank=[m["epochs"] for m in everyone],
                       last_epoch_by_rank=[m["epoch"] for m in everyone])
    return out


def _device(dev, world, everyone) -> dict:
    """The result's ``device``: the peak of the fullest card, each rank
    reading its own (rank 0 touches no other card)."""
    if dev.type != "cuda":          # CPU rehearsals in the tests only
        return {"platform": "cpu", "kind": "cpu", "count": world,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": world,
            "memory_peak_bytes": max(m["peak"] for m in everyone)}


def _gathered(rollout: dict, last_value, dev, world):
    """Every rank's first rollout (fields [T, N, ...], bootstrap values
    [N]) concatenated along the env axis in rank order, on every rank;
    the frame indices, alike on every rank, as they are."""
    def cat(x, dim):
        t = x.to(dev)
        flag = t.dtype == torch.bool
        t = (t.to(torch.uint8) if flag else t).contiguous()
        parts = [torch.empty_like(t) for _ in range(world)]
        tdist.all_gather(parts, t)
        t = torch.cat(parts, dim)
        return t.to(torch.bool) if flag else t

    fields = {}
    for k, v in rollout.items():
        if isinstance(v, dict):
            fields[k] = {kk: cat(vv, 1) for kk, vv in v.items()}
        elif v is None or k == "frame_idx":
            fields[k] = None if v is None else v.to(dev)
        else:
            fields[k] = cat(v, 1)
    return fields, cat(last_value, 0)


# ---- the reference, and control.py -------------------------------------------

def _reference(params: dict, seed: int, dev, rollout, last_value,
               world: int, upto=(STEPS,), sum_order=None):
    """The plain reference over the whole batch, its ranks done in one
    process: its own first rollout from the seed, and its first update
    replayed on ``rollout`` to the last of the steps ``upto``, the ranks'
    shares adding in ``sum_order``: (its rollout, the steps' reading per
    rank)."""
    trainer, ts0, ref_rollout, _ = ref_train.first_rollout(params, seed, dev,
                                                           world)
    trainer.sum_order = sum_order
    steps = ref_train.FirstSteps(ref_ppo, upto, stop=True)
    steps.watch(trainer, ts0.model)
    try:
        ref_train.replay(params, seed, dev, rollout, last_value,
                         start=(trainer, ts0))
    except ref_train.FirstSteps.Done:
        pass
    finally:
        steps.close()
    return ref_rollout, steps.reading(world)


def controls(w: dict, seed: int, dev) -> dict:
    """On one card, the ranks' shares done in one process: the reference
    put in the program's place in TF32 (the control), its rollout of the
    whole batch and its update; and the witness of the sum's order: the
    reference's update on that rollout with the shares adding in reverse
    rank order, against rank order. The looks follow both through the
    whole first epoch: at ``STEPS``, step 12, the first mini-epoch's last
    step and the epoch's."""
    params, world = params_for(w), w["traffic_file"]["ranks"]
    c = params["config"]
    nmb = (int(c["num_actors"]) * int(c["horizon_length"])
           // int(c["minibatch_size"]))
    total = nmb * int(c["mini_epochs"])
    upto = tuple(sorted({m for m in (STEPS, 12, nmb, total) if m <= total}))
    steps = ref_train.FirstSteps(ref_ppo, upto)
    cand = ref_train.follow(params, seed, w["traffic_file"]["checked_epochs"],
                            dev, tf32=True, ranks=world, steps=steps)
    ref_rollout, ref_steps = _reference(params, seed, dev, cand.rollout,
                                        cand.last_value, world, upto)
    _, reverse = _reference(params, seed, dev, cand.rollout,
                            cand.last_value, world, upto,
                            list(reversed(range(world))))
    tf32 = steps.reading(world)
    return {"control_tf32": compare.ranks_numbers(
                cand.rollout, ref_rollout, tf32, ref_steps, STEPS),
            "control_tf32.look": compare.ranks_look(
                cand.rollout, ref_rollout, tf32, ref_steps),
            "witness_sum_order.look": compare.ranks_look(
                ref_rollout, ref_rollout, reverse, ref_steps)}


def readings(w: dict, args, emit) -> None:
    """``control.py`` for this kind: the program on each of ``--seeds``
    and each fault of ``READ`` planted in it on each of ``--fault-seeds``,
    all in one process group; then the control and the witness on each
    of ``--control-seeds``, on rank 0's card alone."""
    dev = torch.device("cuda")
    ints = lambda text: [int(x) for x in text.split(",") if x]
    jobs = [[s, None] for s in ints(args.seeds)] + [
        [s, f] for s in ints(args.fault_seeds) for f in READ]
    t0 = time.perf_counter()

    def done(k, res):
        seed, fault = jobs[k]
        emit({"seed": seed, "reading": f"fault_{fault}" if fault
              else "program", **res["numbers"], "look": res["look"],
              "seconds": time.perf_counter() - t0,
              "memory_peak_bytes": res["device"]["memory_peak_bytes"]})

    if jobs:
        harness.require_cards(w["chips"])
        session(w, jobs, args.seconds, False, t0, dev, on_result=done)
    for s in ints(args.control_seeds):
        t1 = time.perf_counter()
        for name, numbers in controls(w, s, dev).items():
            emit({"seed": s, "reading": name, **numbers,
                  "seconds": time.perf_counter() - t1})


# ---- a rank other than 0 ----------------------------------------------------

def _child_main() -> int:
    # nothing a rank other than 0 prints reaches the result's stream
    os.dup2(2, 1)
    torch.set_num_threads(1)
    job = json.loads(sys.stdin.read())
    parent = os.getppid()

    def watch_parent():
        while os.getppid() == parent:
            time.sleep(0.5)
        os._exit(ENDED)
    threading.Thread(target=watch_parent, daemon=True).start()
    _worker(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
            job["w"], job["jobs"], job["seconds"], job["trace"],
            torch.device(job["device"]), time.perf_counter(), "env://")
    return 0


if __name__ == "__main__":
    from portbench.drivers import train_ranks
    sys.exit(train_ranks._child_main())
