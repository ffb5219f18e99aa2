"""The witness of the sum's order (``drivers/train_ranks.controls``): the
reference's update with the ranks' shares adding in reverse rank order,
against rank order. Over two ranks floating-point addition commutes, so
the witness reads 0 to the bit, as two gloo ranks read 0 against the
reference; over four the order of the sum is the difference. On the CPU
at the tiny sizes; the card reads it at the cell's own."""
from __future__ import annotations

import pytest
import torch

from portbench import harness
from portbench.tests import _tiny

CELL = "planning.train.4gpu"


@pytest.fixture(scope="module")
def readings():
    w = _tiny.cell(CELL)
    return harness.driver("train_ranks").controls(w, 2 ** 31 + 19,
                                                  torch.device("cpu"))


def test_reverse_sum_over_two_ranks_is_bitwise_rank_order(readings):
    look = readings["witness_sum_order.look"]
    gaps = {k: v for k, v in look.items()
            if "_gap." in k and isinstance(v, float)}
    assert gaps and all(v == 0.0 for v in gaps.values()), gaps


@pytest.mark.parametrize("name", ["rollout_gap.p99", "loss_gap.steps1-3",
                                  "grad_gap.step1", "change_gap.steps1-3"])
def test_control_reads_each_number_of_the_gate(readings, name):
    assert name in readings["control_tf32"], readings["control_tf32"]
