"""A run with the timed path broken underneath comes out not correct:
each fault the cell can have, planted in the program, at a tiny size on
the CPU (the harness's look for a card is skipped: the drivers are
driven directly)."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from portbench import harness
from portbench.tests import _tiny


def _unchanged_state(monkeypatch):
    """The update returns its state unchanged."""
    from airgym_tpu_torch.rl import fused_ppo, ppo
    for cls in (ppo.PPO, fused_ppo.FusedHoveringPPO):
        monkeypatch.setattr(cls, "update",
                            lambda self, ts, dataset: (ts, {
                                k: torch.zeros(()) for k in ppo.METRICS}))


def _half_batch(monkeypatch):
    """Each minibatch's loss is the mean over its first half alone."""
    from airgym_tpu_torch.rl import fused_ppo, ppo
    from portbench.reference import train as ref_train
    for cls in (ppo.PPO, fused_ppo.FusedHoveringPPO):
        init = cls.__init__

        def patched(self, *a, _init=init, **k):
            _init(self, *a, **k)
            ref_train.plant_half_batch(self)
        monkeypatch.setattr(cls, "__init__", patched)


@pytest.mark.parametrize("name", ["hovering.train", "planning.train"])
@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch])
def test_training_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    w = _tiny.cell(name)
    res = _tiny.run(name, w=w)
    ok, checks = harness.judge(res["numbers"], w["limits"])
    assert not ok, checks


def _sim_state_unchanged(monkeypatch):
    from airgym_tpu_torch.ops import fused_hovering as fh
    monkeypatch.setattr(fh, "rollout_fused", lambda packed, action, seed,
                        steps, motor_alpha=0.0: (
                            packed.clone(), torch.zeros(packed.shape[1])))


def _sim_answer_altered(monkeypatch):
    """Every env's reward sum 1% off where the kernel produces it."""
    from airgym_tpu_torch.ops import fused_hovering as fh
    orig = fh.rollout_fused

    def altered(packed, action, seed, steps, motor_alpha=0.0):
        out, rew = orig(packed, action, seed, steps, motor_alpha)
        return out, rew * 1.01
    monkeypatch.setattr(fh, "rollout_fused", altered)


@pytest.mark.parametrize("fault", [_sim_state_unchanged,
                                   _sim_answer_altered])
def test_sim_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    w = _tiny.cell("hovering.sim")
    res = _tiny.run("hovering.sim", w=w)
    ok, checks = harness.judge(res["numbers"], w["limits"])
    assert not ok, checks
