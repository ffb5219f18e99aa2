"""Tiny CPU versions of the cells for the benchmark's own tests: the
cell's files with its sizes cut (the card runs them at full size)."""
from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

CPU = torch.device("cpu")
SIZES = {"hovering.train": dict(num_actors=1024, horizon_length=4,
                                minibatch_size=2048, mini_epochs=2),
         "planning.train": dict(num_actors=8, horizon_length=8,
                                minibatch_size=32, mini_epochs=2),
         # per rank, as the configuration's YAML: 8 envs over two ranks
         "planning.train.4gpu": dict(num_actors=4, horizon_length=8,
                                     minibatch_size=16, mini_epochs=2)}
# a cell over ranks: two gloo ranks on the CPU; a loaded host can hold one
# rank back from the other for a minute
RANKS = {"planning.train.4gpu": dict(ranks=2, collective_timeout_s=300,
                                     deadline_s=600)}


def cell(name: str) -> dict:
    w = harness.cell(name)
    if name in SIZES:
        w["config_file"]["params"]["config"].update(SIZES[name])
    else:
        w["traffic_file"].update(num_envs=2048, steps=40, checked_envs=16,
                                 checked_calls=2)
    w["traffic_file"].update(RANKS.get(name, {}))
    return w


def run(name: str, seed: int = 2 ** 31 + 5, w=None) -> dict:
    """The cell's run on the CPU (no window to speak of, no trace)."""
    w = w or cell(name)
    driver = harness.driver(w["traffic_file"]["kind"])
    return driver.run(w, seed, 0.0, False, time.perf_counter(), CPU)
