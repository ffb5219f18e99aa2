"""BENCHMARK.json against the benchmark's rules, and each cell's files
found by name (CPU; no card needed)."""
from __future__ import annotations

import json
import re
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names += [w["name"], w["traffic"]]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and "\t" not in m["layer"]
    assert all(NAME.match(n) for n in names), names
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [x["name"] for x in SPEC[group]]
        assert len(set(group_names)) == len(group_names)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for w in SPEC["workloads"]:
        cell = harness.cell(w["name"], SPEC)
        got = [m["name"] for m in cell["end_to_end"]]
        assert "setup_s" in got and len(got) >= 2
        assert cell["per_layer"]
        for m in cell["per_layer"]:
            # each per-layer metric moves an end-to-end metric its cell
            # reports
            assert m["moves"] in got and m["moves"] in e2e
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= 1


def test_cell_files_found_by_name():
    for w in SPEC["workloads"]:
        cell = harness.cell(w["name"], SPEC)
        assert cell["traffic_file"]["kind"] in ("train", "sim")
        assert set(cell["limits"]) and all(
            "limit" in v for v in cell["limits"].values())
        for m in cell["per_layer"]:
            assert callable(harness.reader(m["name"]))
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(SPEC["paths"][0] + "/")


def test_adding_a_cell_is_data_only(tmp_path, monkeypatch):
    """A copy of the benchmark gains a cell from new data files alone: a
    traffic mix, its limits and a BENCHMARK.json entry; the harness finds
    them by name."""
    bench = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    traffic = json.loads((bench / "traffic" / "sim.json").read_text())
    traffic.update(action=[0.0, 0.0, 0.0, 0.4], steps=64)
    (bench / "traffic" / "sim.climb.json").write_text(json.dumps(traffic))
    shutil.copy(bench / "limits" / "hovering.sim.json",
                bench / "limits" / "hovering.sim.climb.json")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "hovering.sim.climb",
                              "config": "hovering", "traffic": "sim.climb",
                              "chips": 1, "why": "every env resets"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "hovering.sim" in m.get("workloads", []):
            m["workloads"].append("hovering.sim.climb")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(harness, "HERE", bench)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    cell = harness.cell("hovering.sim.climb")
    assert cell["traffic_file"]["action"][3] == 0.4
    assert {m["name"] for m in cell["end_to_end"]} == {"sim_steps_s",
                                                       "setup_s"}
    assert all(callable(harness.reader(m["name"]))
               for m in cell["per_layer"])


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        harness.cell("hovering.nothing", SPEC)
