"""Traffic of kind ``sim``: env-only stepping through the env-only kernel.

Set-up makes the task's env batch from the seed (``initial_state``),
packs it (``ops/fused_hovering.pack_state``), remaps the traffic's action
and makes one call, which builds and warms the kernel. The window then
calls ``rollout_fused(packed, action, seed_i, steps)`` from the same
packed state with a new seed each time and reads the summed reward after
each call, as bench.py's env-only rate does; it ends at the first call
boundary after ``--seconds``. Each call's seed and a sample of its
outputs, drawn from the run's seed, are kept for the reference.
"""
from __future__ import annotations

import gc
import math
import random
import time

import torch

from portbench import harness
from portbench import trace as trace_mod
from portbench.counts import work
from portbench.reference import compare
from portbench.reference import sim as ref_sim


def _call_seed(rng: random.Random) -> int:
    return rng.getrandbits(32)


def run(w: dict, seed: int, seconds: float, trace: bool, t_start: float,
        dev=torch.device("cuda")) -> dict:
    from airgym_tpu_torch import envs
    from airgym_tpu_torch.ops import fused_hovering as fh
    tr = w["traffic_file"]
    n, steps = tr["num_envs"], tr["steps"]
    task = envs.make_task(w["config_file"]["params"]["config"]["env_name"],
                          ctl_mode="rate", num_envs=n, obs_noise=False,
                          device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    packed = fh.pack_state(task.initial_state(gen).core)
    act = task.remap_actions(torch.tensor([tr["action"]],
                                          dtype=torch.float32,
                                          device=dev))[0]
    rng = random.Random(seed)
    env_idx = torch.tensor(sorted(rng.sample(range(n), tr["checked_envs"])),
                           device=dev)
    _, r = fh.rollout_fused(packed, act, _call_seed(rng), steps)
    float(torch.sum(r))
    setup_s = time.perf_counter() - t_start

    # the checked calls: a uniform sample of the window's, drawn from the
    # seed as the window goes (reservoir sampling keeps only the sample)
    k, pick, kept = tr["checked_calls"], random.Random(~seed), []
    calls = failed = 0
    t0 = time.perf_counter()
    while True:
        s_i = _call_seed(rng)
        out, r = fh.rollout_fused(packed, act, s_i, steps)
        total = float(torch.sum(r))
        failed += not math.isfinite(total)
        slot = calls if calls < k else pick.randrange(calls + 1)
        if slot < k:
            sample = (s_i, out[0:fh.NROWS, env_idx], r[env_idx])
            kept[slot:slot + 1] = [sample]
        calls += 1
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0

    res = {"metrics": {}}
    if trace:
        least = work.least_s(*work.env_work(n, steps, _resets(packed, steps)))
        with trace_mod.Window() as win:
            units, t1 = 0, time.perf_counter()
            while units == 0 or time.perf_counter() - t1 < tr[
                    "profile_seconds"]:
                win.marks("rollout_fused")
                _, r = fh.rollout_fused(packed, act, _call_seed(rng), steps)
                win.marks("reading the summed reward")
                float(torch.sum(r))
                units += 1
        reading = win.read()
        ctx = {"trace": reading, "least": {"env_kernel": least * units}}
        res["metrics"] = harness.per_layer(w, ctx)
        res["breakdown"] = reading.breakdown()
        res["device"] = harness.device_info(w["chips"], dev)
        res["device"]["busy_s"] = reading.busy_s()
        res["device"]["window_s"] = reading.window_s
    else:
        rate = calls * n * steps / elapsed
        for m in w["end_to_end"]:
            value = {"setup_s": setup_s}.get(m["name"], rate)
            res["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        res["device"] = harness.device_info(w["chips"], dev)
    res.update(attempted=calls, failed=failed)

    prog_rows = torch.cat([x[1] for x in kept], dim=1)
    prog_rew = torch.cat([x[2] for x in kept])
    seeds = [x[0] for x in kept]
    del task, packed, kept, out, r
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    res["numbers"], res["look"] = check(n, seed, tr, env_idx, seeds,
                                        prog_rows, prog_rew)
    res["look"].update(setup_s=setup_s, window_s=elapsed,
                       reference_s=time.perf_counter() - t_ref)
    return res


def _resets(packed, steps: int) -> int:
    """A lower bound on the resets of one call: each env's time-outs had
    it no exit (an exit resets it once more and only delays its
    time-outs)."""
    prog = packed[19].to(torch.int64)
    return int(torch.sum((prog + steps) // work.HOVER_EPISODE))


def check(n, seed, tr, env_idx, seeds, prog_rows, prog_rew):
    """The reference's sample beside the program's."""
    dev = env_idx.device
    packed, act = ref_sim.initial(n, seed, tr["action"], dev)
    cols = packed[:, env_idx]
    k = len(seeds)
    call_seeds = torch.tensor(seeds, dtype=torch.int64,
                              device=dev).repeat_interleave(len(env_idx))
    rows, rew = ref_sim.follow(cols.repeat(1, k), act, call_seeds,
                               env_idx.repeat(k), tr["steps"])
    return (compare.sim_numbers(prog_rows, prog_rew, rows, rew),
            compare.sim_look(prog_rows, prog_rew, rows, rew))


def controls(w: dict, seed: int, dev) -> dict:
    """``control.py``'s readings of an env-only cell on ``seed``: the
    reference's state kept in bf16 (the control), a step that returns its
    state unchanged and every answer 1% off (faults)."""
    tr = w["traffic_file"]
    n = tr["num_envs"]
    rng = random.Random(seed)
    env_idx = torch.tensor(sorted(rng.sample(range(n), tr["checked_envs"])),
                           device=dev)
    seeds = [rng.getrandbits(32) for _ in range(tr["checked_calls"])]
    packed, act = ref_sim.initial(n, seed, tr["action"], dev)
    k = len(seeds)
    cols = packed[:, env_idx].repeat(1, k)
    call_seeds = torch.tensor(seeds, dtype=torch.int64,
                              device=dev).repeat_interleave(len(env_idx))
    idx = env_idx.repeat(k)
    rows, rew = ref_sim.follow(cols, act, call_seeds, idx, tr["steps"])
    rows_b, rew_b = ref_sim.follow(cols, act, call_seeds, idx, tr["steps"],
                                   store=torch.bfloat16)
    return {
        "control_bf16": compare.sim_numbers(rows_b, rew_b, rows, rew),
        "control_bf16.look": compare.sim_look(rows_b, rew_b, rows, rew),
        "fault_state_unchanged": compare.sim_numbers(
            cols[0:rows.shape[0]], torch.zeros_like(rew), rows, rew),
        "fault_answer_altered": compare.sim_numbers(rows, rew * 1.01, rows,
                                                    rew)}
