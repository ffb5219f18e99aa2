"""What every cell shares: the spec and the cell's files found by name,
the device checks, the per-layer readers, the comparison with its limits
and the result line."""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names the run must never hold: JAX and the JAX package
# (compared whole: the port's own name begins with the JAX package's)
BANNED = ("jax", "jaxlib", "flax", "airgym_tpu")


def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str, sp: Optional[dict] = None) -> dict:
    """The cell's entry with its configuration, traffic, limits and the
    metrics it reports, each found by name."""
    sp = sp or spec()
    cells = {w["name"]: w for w in sp["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; have {sorted(cells)}")
    w = dict(cells[name])
    cfg = {c["name"]: c for c in sp["configs"]}[w["config"]]
    w["config_file"] = json.loads((ROOT / cfg["file"]).read_text())
    w["traffic_file"] = json.loads(
        (HERE / "traffic" / f"{w['traffic']}.json").read_text())
    w["limits"] = json.loads((HERE / "limits" / f"{name}.json").read_text())
    mine = lambda m: name in m.get("workloads", [name])
    w["end_to_end"] = [m for m in sp["end_to_end"] if mine(m)]
    w["per_layer"] = [m for m in sp["per_layer"] if mine(m)]
    return w


def load_file(path: Path, name: str):
    """The module in ``path`` (a file found by name), loaded as ``name``."""
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(metric: str) -> Callable[[dict], Optional[float]]:
    """``metrics/<metric>.py``'s ``read(ctx)``."""
    return load_file(HERE / "metrics" / f"{metric}.py",
                     f"portbench_metric_{metric.replace('.', '_')}").read


def kinds() -> list:
    """The traffic kinds that have a driver (``drivers/<kind>.py``)."""
    return sorted(p.stem for p in (HERE / "drivers").glob("*.py")
                  if not p.stem.startswith("_"))


def driver(kind: str):
    """``drivers/<kind>.py``, the general driver of a traffic kind: its
    ``run(w, seed, seconds, trace, t_start)`` makes one run. A kind with
    no driver file exits non-zero, naming the kinds present."""
    if kind not in kinds():
        raise SystemExit(f"traffic kind {kind!r} has no driver "
                         f"(portbench/drivers/{kind}.py); kinds: {kinds()}")
    return importlib.import_module(f"portbench.drivers.{kind}")


def require_cards(n: int) -> None:
    """A measurement needs CUDA and ``n`` cards; there is no fallback."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark measures the port "
                         "on the card and does not fall back to the CPU")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"the cell needs {n} CUDA devices, "
                         f"{torch.cuda.device_count()} visible")


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def judge(numbers: Dict[str, float], limits: Dict[str, Any]) -> tuple:
    """(correct, {name: {value, limit}}): each number at or under its
    limit; a number that is not finite fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits[name]["limit"]
        checks[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_info(count: int, dev: torch.device) -> dict:
    if dev.type != "cuda":       # CPU rehearsals in the tests only
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in range(count))}


def per_layer(w: dict, ctx: dict) -> dict:
    out = {}
    for m in w["per_layer"]:
        value = reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
