"""The cell over ranks with the timed path broken underneath comes out
not correct, once for each fault it can have, planted in the program on
the ranks (``drivers/train_ranks.FAULTS``): a step that returns its state
unchanged, half of each share left out, the exchange between ranks left
out on one rank, and rank 0's envs taken from the wrong rows. Two gloo
ranks on the CPU at the tiny sizes; one spawn of the ranks runs them
all."""
from __future__ import annotations

import time

import pytest
import torch

from portbench import harness
from portbench.tests import _tiny

CELL = "planning.train.4gpu"
FAULTS = ("state_unchanged", "half_batch", "skip_allreduce", "wrong_rows")


@pytest.fixture(scope="module")
def results():
    w = _tiny.cell(CELL)
    driver = harness.driver(w["traffic_file"]["kind"])
    res = driver.session(w, [[2 ** 31 + 13, f] for f in FAULTS], 0.0, False,
                         time.perf_counter(), torch.device("cpu"))
    return w, dict(zip(FAULTS, res))


@pytest.mark.parametrize("fault", FAULTS)
def test_rank_fault_is_not_correct(results, fault):
    w, res = results
    ok, checks = harness.judge(res[fault]["numbers"], w["limits"])
    assert not ok, checks
