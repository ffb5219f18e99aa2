"""Task registry (counterpart of airgym_tpu/envs/__init__.py).

Every task of the JAX package: Hovering, Balloon, Tracking, Planning,
Avoid, MAPlanning, DepthGen and Customized, the template for new vision
tasks. ``register(name, task_cls, cfg_cls)`` adds a task (a Customized
subclass, say) that ``make_task`` and the runner then build by name;
``get_cfg(name, **overrides)`` is its config.

``make_task(name, ...)`` returns the functional task whose ``step`` the
trainers call; ``make_env(name, seed, ...)`` the stateful reference-API
wrapper (``base.TaskWrapper``) over it.
"""
from __future__ import annotations

import dataclasses

from airgym_tpu_torch import device as device_mod
from airgym_tpu_torch.envs.avoid import Avoid, AvoidCfg
from airgym_tpu_torch.envs.balloon import Balloon, BalloonCfg
from airgym_tpu_torch.envs.customized import Customized, CustomizedCfg
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
             "depthgen": (DepthGen, DepthGenCfg),
             "customized": (Customized, CustomizedCfg)}


def register(name: str, task_cls: type, cfg_cls: type) -> None:
    """Add (or replace) a task under ``name``."""
    _REGISTRY[name] = (task_cls, cfg_cls)


def registered_tasks():
    return sorted(_REGISTRY)


def get_cfg(name: str, **overrides):
    """The registered task's default config with ``overrides``."""
    _, cfg_cls = _REGISTRY[name]
    return dataclasses.replace(cfg_cls(), **overrides)


def make_task(name: str, ctl_mode: str = "rate", num_envs: int | None = None,
              device=None, **overrides):
    """Functional task on ``device`` (default ``cuda``)."""
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
