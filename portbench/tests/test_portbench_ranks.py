"""The cell over ranks, rehearsed on the CPU with two gloo ranks: every
rank stops at the same epoch boundary and only rank 0 prints the
result (one spawn of the ranks for the file)."""
from __future__ import annotations

import ast
import json

import pytest

from portbench.tests import _ranks


@pytest.fixture(scope="module")
def sound():
    return _ranks.run(seed=2 ** 31 + 11, seconds=1.0)[0]


def test_only_rank_0_prints_the_result(sound):
    assert sound.returncode == 0, sound.stderr[-4000:]
    lines = sound.stdout.strip().splitlines()
    assert len(lines) == 1, lines
    res = json.loads(lines[0])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["count"] == 2
    assert set(res["metrics"]) == {"vision_train_steps_s", "setup_s"}


def test_ranks_stop_at_the_same_epoch(sound):
    look = {}
    for line in sound.stderr.splitlines():
        if line.startswith("look "):
            name, value = line[len("look "):].split(": ", 1)
            look[name] = ast.literal_eval(value)
    epochs = look["epochs_by_rank"]
    assert len(epochs) == 2 and len(set(epochs)) == 1, epochs
    assert epochs[0] == json.loads(sound.stdout.strip())["attempted"] >= 1
    assert len(set(look["last_epoch_by_rank"])) == 1
