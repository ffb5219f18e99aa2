"""The control comes out not correct: the reference put in the program's
place one precision below the configuration's. The limits are set from
``control.py``'s readings on the card at the cells' sizes; the card's
test runs the training cells at their own size (a minute or two), the
CPU's test the env-only cell at a tiny one."""
from __future__ import annotations

import pytest
import torch

from portbench import control, harness
from portbench.tests import _tiny


def test_sim_control_bf16_is_not_correct():
    w = _tiny.cell("hovering.sim")
    numbers = control.sim_controls(w, 2 ** 31 + 9,
                                   torch.device("cpu"))["control_bf16"]
    assert not harness.judge(numbers, w["limits"])[0], numbers


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hovering.train", "planning.train"])
def test_train_control_tf32_is_not_correct(name):
    """TF32 exists only on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 is a tensor-core precision")
    w = harness.cell(name)
    readings = control.train_controls(w, 2 ** 31 + 9, torch.device("cuda"))
    for key in ("control_tf32", "fault_half_batch"):
        assert not harness.judge(readings[key], w["limits"])[0], (
            key, readings[key])
