"""The two tasks the benchmark's configurations train."""
from __future__ import annotations

import dataclasses

from portbench.reference.plain import device as device_mod
from portbench.reference.plain.envs.hovering import Hovering, HoveringCfg
from portbench.reference.plain.envs.planning import Planning, PlanningCfg

_REGISTRY = {"hovering": (Hovering, HoveringCfg),
             "planning": (Planning, PlanningCfg)}


def make_task(name: str, num_envs: int, device=None, **overrides):
    task_cls, cfg_cls = _REGISTRY[name]
    cfg = dataclasses.replace(cfg_cls(), num_envs=num_envs, **overrides)
    return task_cls(cfg, device_mod.resolve(device))
