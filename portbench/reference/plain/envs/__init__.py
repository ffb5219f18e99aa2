"""The tasks the benchmark's configurations train, each in a file of its
own: ``<env_name>.py`` names its task class ``TASK`` and its config
dataclass ``CFG``."""
from __future__ import annotations

import dataclasses
import importlib
from pathlib import Path

from portbench.reference.plain import device as device_mod

HERE = Path(__file__).resolve().parent


def names() -> list:
    return sorted(p.stem for p in HERE.glob("*.py")
                  if not p.stem.startswith("_") and p.stem != "base")


def make_task(name: str, num_envs: int, device=None, **overrides):
    """The task of ``<name>.py``, found by name."""
    if name not in names():
        raise ValueError(f"the reference has no task {name!r} "
                         f"(reference/plain/envs/{name}.py); has {names()}")
    mod = importlib.import_module(f"{__name__}.{name}")
    cfg = dataclasses.replace(mod.CFG(), num_envs=num_envs, **overrides)
    return mod.TASK(cfg, device_mod.resolve(device))
