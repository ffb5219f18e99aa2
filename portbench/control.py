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
  measure and needs no run. A cell over ranks has its faults planted in
  the program itself on each of ``--fault-seeds``
  (``drivers/train_ranks.FAULTS``), and reads beside its control the
  witness of the order in which the ranks' shares add (the reference
  against itself with the shares summed in reverse rank order).

The cell's driver (``drivers/<kind>.py``) gives the readings: its
``controls``, or its own ``readings`` where the program runs over
several processes.

``--epochs N`` follows a training cell through N checked epochs instead
of the traffic's ``checked_epochs``: the drift study behind comparing the
first epoch alone (each epoch's loss gap and the change over all N are
``look`` readings).

    python3 portbench/control.py --workload hovering.train \\
        --seeds 11,12,... --control-seeds 21,22,23 [--epochs 3] [--out FILE]
    python3 portbench/control.py --workload planning.train.4gpu \\
        --seeds 11,12,... --fault-seeds 31,32,33 --seconds 0.1
    python3 portbench/control.py --workload planning.train.4gpu \\
        --control-seeds 21,22,23      # one card: control and witness

One JSON line per reading; ``--out`` also writes them all there.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402


def readings(w, args, emit, driver) -> None:
    """The program on each of ``--seeds`` (``driver.run``: set-up, a short
    window, the comparison), then ``driver.controls`` on each of
    ``--control-seeds``."""
    harness.require_cards(w["chips"])
    dev = torch.device("cuda")
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
        for name, numbers in driver.controls(w, s, dev).items():
            emit({"seed": s, "reading": name, **numbers,
                  "seconds": time.perf_counter() - t0})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="",
                    help="seeds of the faults a driver plants in the "
                         "program itself (drivers/train_ranks.FAULTS)")
    ap.add_argument("--seconds", type=float, default=0.1)
    ap.add_argument("--epochs", type=int, default=0,
                    help="checked epochs of a training cell (0: the "
                         "traffic's)")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    w = harness.cell(args.workload)
    if args.epochs:
        w["traffic_file"]["checked_epochs"] = args.epochs
    driver = harness.driver(w["traffic_file"]["kind"])
    harness.require_cards(1)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    # a driver that runs the program over several processes reads its
    # seeds, controls and faults itself
    own = getattr(driver, "readings", None)
    if own is not None:
        own(w, args, emit)
    else:
        readings(w, args, emit, driver)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
