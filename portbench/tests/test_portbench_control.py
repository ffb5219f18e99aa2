"""The control comes out not correct: the reference put in the program's
place one precision below the configuration's. The limits are set from
``control.py``'s readings on the card at the cells' sizes; the card's
test runs the training cells at their own size (a minute or two), the
CPU's test the env-only cell at a tiny one. A driver's ``controls``
gives the readings."""
from __future__ import annotations

import pytest
import torch

from portbench import harness
from portbench.tests import _tiny


def test_sim_control_bf16_is_not_correct():
    w = _tiny.cell("hovering.sim")
    numbers = harness.driver("sim").controls(
        w, 2 ** 31 + 9, torch.device("cpu"))["control_bf16"]
    assert not harness.judge(numbers, w["limits"])[0], numbers


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hovering.train", "planning.train",
                                  "planning.train.4gpu"])
def test_train_control_tf32_is_not_correct(name):
    """TF32 exists only on the card. The cell over ranks reads its control
    on one card: the reference runs in one process."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 is a tensor-core precision")
    w = harness.cell(name)
    readings = harness.driver(w["traffic_file"]["kind"]).controls(
        w, 2 ** 31 + 9, torch.device("cuda"))
    for key, numbers in readings.items():
        if not key.endswith(".look"):
            assert not harness.judge(numbers, w["limits"])[0], (key, numbers)
