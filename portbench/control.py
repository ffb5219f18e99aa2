"""Readings that the limits of ``limits/<cell>.json`` are set from, on
the card at the cell's own size:

- the program: the cell's run (set-up, a short window, the comparison)
  on each of ``--seeds``;
- the control: the reference put in the program's place in the nearest
  precision below the configuration's (training: TF32 products;
  env-only: the state kept in bf16), on each of ``--control-seeds``;
- the faults the cell can have, planted in the reference put in the
  program's place: half of each minibatch left out (training), a step
  that returns its state unchanged and every answer 1% off (env-only); a
  training step that returns its state unchanged reads 1 by the change's
  measure and needs no run.

``--epochs N`` follows a training cell through N checked epochs instead
of the traffic's ``checked_epochs``: the drift study behind comparing the
first epoch alone (each epoch's loss gap and the change over all N are
``look`` readings).

    python3 portbench/control.py --workload hovering.train \\
        --seeds 11,12,... --control-seeds 21,22,23 [--epochs 3] [--out FILE]

One JSON line per reading; ``--out`` also writes them all there.
"""
from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402
from portbench.reference import compare  # noqa: E402
from portbench.reference import sim as ref_sim  # noqa: E402
from portbench.reference import train as ref_train  # noqa: E402


def train_controls(w, seed, dev):
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


def sim_controls(w, seed, dev):
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.1)
    ap.add_argument("--epochs", type=int, default=0,
                    help="checked epochs of a training cell (0: the "
                         "traffic's)")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    w = harness.cell(args.workload)
    if args.epochs:
        w["traffic_file"]["checked_epochs"] = args.epochs
    harness.require_cards(w["chips"])
    dev = torch.device("cuda")
    kind = w["traffic_file"]["kind"]
    if kind == "train":
        from portbench.drivers import train as driver
        controls = train_controls
    else:
        from portbench.drivers import sim as driver
        controls = sim_controls
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    for s in [int(x) for x in args.seeds.split(",") if x]:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        res = driver.run(w, s, args.seconds, False, t0, dev)
        emit({"seed": s, "reading": "program", **res["numbers"],
              "look": res["look"],
              "seconds": time.perf_counter() - t0,
              "memory_peak_bytes": res["device"]["memory_peak_bytes"]})
    for s in [int(x) for x in args.control_seeds.split(",") if x]:
        t0 = time.perf_counter()
        for name, numbers in controls(w, s, dev).items():
            emit({"seed": s, "reading": name, **numbers,
                  "seconds": time.perf_counter() - t0})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
