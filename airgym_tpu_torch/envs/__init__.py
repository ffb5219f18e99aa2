"""Task registry (counterpart of airgym_tpu/envs/__init__.py).

Ported: Hovering, Balloon, Tracking, Planning, Avoid, MAPlanning and
DepthGen. Customized is still to come (ROADMAP.md queue A item 11), and
``make_task`` refuses it.

``make_task(name, ...)`` returns the functional task whose ``step`` the
trainers call; ``make_env(name, seed, ...)`` the stateful reference-API
wrapper (``base.TaskWrapper``) over it.
"""
from __future__ import annotations

import dataclasses

from airgym_tpu_torch import device as device_mod
from airgym_tpu_torch.envs.avoid import Avoid, AvoidCfg
from airgym_tpu_torch.envs.balloon import Balloon, BalloonCfg
from airgym_tpu_torch.envs.depthgen import DepthGen, DepthGenCfg
from airgym_tpu_torch.envs.hovering import Hovering, HoveringCfg
from airgym_tpu_torch.envs.maplanning import MAPlanning, MAPlanningCfg
from airgym_tpu_torch.envs.planning import Planning, PlanningCfg
from airgym_tpu_torch.envs.tracking import Tracking, TrackingCfg

_REGISTRY = {"hovering": (Hovering, HoveringCfg),
             "balloon": (Balloon, BalloonCfg),
             "tracking": (Tracking, TrackingCfg),
             "planning": (Planning, PlanningCfg),
             "avoid": (Avoid, AvoidCfg),
             "maplanning": (MAPlanning, MAPlanningCfg),
             "depthgen": (DepthGen, DepthGenCfg)}

_NOT_PORTED = {"customized": "queue A item 11"}


def registered_tasks():
    return sorted(_REGISTRY)


def make_task(name: str, ctl_mode: str = "rate", num_envs: int | None = None,
              device=None, **overrides):
    """Functional task on ``device`` (default ``cuda``)."""
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"task {name!r} is not ported yet: ROADMAP.md {_NOT_PORTED[name]}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown task {name!r}; have {registered_tasks()}")
    task_cls, cfg_cls = _REGISTRY[name]
    kw = dict(ctl_mode=ctl_mode, **overrides)
    if num_envs is not None:
        kw["num_envs"] = num_envs
    cfg = dataclasses.replace(cfg_cls(), **kw)
    return task_cls(cfg, device_mod.resolve(device))


def make_env(name: str, seed: int = 0, **kw):
    """``base.TaskWrapper`` over ``make_task(name, **kw)``."""
    from airgym_tpu_torch.envs.base import TaskWrapper
    return TaskWrapper(make_task(name, **kw), seed=seed)
