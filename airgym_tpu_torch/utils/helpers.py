"""Config helpers (counterpart of airgym_tpu/utils/helpers.py; reference
airgym/utils/helpers.py): the pure config utilities. The reference's
gym_utils / gymapi stubs, which let its configs import without IsaacGym,
have nothing to stand in for here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict


def class_to_dict(obj: Any) -> Dict[str, Any]:
    """Recursive class-tree/dataclass -> dict (reference helpers.py:23-38)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: class_to_dict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if not hasattr(obj, "__dict__") and not hasattr(obj, "__slots__"):
        return obj
    if isinstance(obj, (int, float, str, bool, tuple, list, dict,
                        type(None))):
        return obj
    result = {}
    for key in dir(obj):
        if key.startswith("_"):
            continue
        val = getattr(obj, key)
        if callable(val):
            continue
        result[key] = class_to_dict(val) if hasattr(val, "__dict__") else val
    return result


def update_cfg_from_args(cfg, args: Dict[str, Any]):
    """CLI overrides onto a frozen dataclass config (reference
    helpers.py:64-80): returns a replaced copy."""
    updates = {}
    for field in ("num_envs", "ctl_mode", "episode_length_s"):
        if args.get(field) is not None:
            updates[field] = args[field]
    if updates:
        cfg = dataclasses.replace(cfg, **updates)
    return cfg, args.get("seed")
