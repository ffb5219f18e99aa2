"""BENCHMARK.json against the benchmark's rules, and each cell's files
found by name (CPU; no card needed)."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import textwrap
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
        assert callable(harness.driver(cell["traffic_file"]["kind"]).run)
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


def test_unknown_kind_is_refused():
    with pytest.raises(SystemExit, match="kinds: .*'train'"):
        harness.driver("nothing")


def test_unknown_kind_gives_no_result(tmp_path):
    """A run whose traffic names a kind with no driver file exits non-zero
    with no result line, naming the kinds present."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = tmp_path / "portbench" / "traffic" / "sim.json"
    traffic = json.loads(path.read_text())
    path.write_text(json.dumps(dict(traffic, kind="nothing")))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "hovering.sim",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
    assert "kinds: ['sim', 'train', 'train_ranks']" in out.stderr


# a tiny frozen-backbone image encoder and its count, as a configuration
# that brings an encoder would add them
TINY_ENCODER = '''
"""A tiny frozen-backbone image encoder: a frozen conv, a trained fc."""
import torch
from torch import nn

MODULE = "actor_tiny"


class Tiny(nn.Module):
    def __init__(self, features, generator):
        super().__init__()
        self.backbone = nn.Conv2d(1, 4, 3, stride=2)
        self.fc = nn.Linear(4, features)
        with torch.no_grad():
            for p in self.parameters():
                p.normal_(0.0, 0.1, generator=generator)
        self.backbone.requires_grad_(False)

    def forward(self, x):
        with torch.no_grad():
            y = self.backbone(x).abs().mean((2, 3))
        return self.fc(y)


def build(block, generator):
    features = int(block.get("output_dim", 30))
    return Tiny(features, generator), features
'''
TINY_COUNT = '''
PEAK = 1e12


def forward_flops(w, h, images):
    return 2.0 * 9 * 4 * images * ((w - 1) // 2) * ((h - 1) // 2)


def train_flops(w, h, images):
    return forward_flops(w, h, images)


def nbytes(w, h, images):
    return 4.0 * images * w * h
'''


def test_adding_a_configuration_is_files_only(tmp_path):
    """A copy of the benchmark gains a configuration whose network names
    an encoder the frozen reference lacks, from new files alone
    (``configs/<x>.json``, ``reference/plain/models/<enc>.py``,
    ``counts/encoders/<enc>.py``) and BENCHMARK.json entries: the
    reference builds it, its Adam leaves the frozen parameters as they
    were, and ``Work`` counts the encoder under its name (one with no
    count file as nothing)."""
    bench = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((bench / "configs" / "planning.json").read_text())
    net = cfg["params"]["network"]
    net["tiny"] = net.pop("cnn")
    (bench / "configs" / "planning_tiny.json").write_text(json.dumps(cfg))
    (bench / "reference" / "plain" / "models" / "tiny.py").write_text(
        TINY_ENCODER)
    (bench / "counts" / "encoders" / "tiny.py").write_text(TINY_COUNT)
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "planning_tiny", "source": "test",
                            "file": "portbench/configs/planning_tiny.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "planning_tiny.train",
                              "config": "planning_tiny", "traffic": "train",
                              "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    shutil.copy(bench / "limits" / "planning.train.json",
                bench / "limits" / "planning_tiny.train.json")
    code = textwrap.dedent(f"""
        import sys, types, torch
        sys.path.insert(0, {str(tmp_path)!r})
        sys.path.append({str(ROOT)!r})
        from portbench import harness
        from portbench.drivers import train
        from portbench.metrics import _common
        from portbench.reference import train as ref_train
        assert harness.__file__.startswith({str(tmp_path)!r})
        w = harness.cell("planning_tiny.train")
        params = w["config_file"]["params"]
        params["config"].update(num_actors=4, horizon_length=8,
                                minibatch_size=16, mini_epochs=2)
        trainer = ref_train.build(params, torch.device("cpu"))
        ts = trainer.init(7)
        before = {{k: v.detach().clone()
                  for k, v in ts.model.named_parameters()}}
        frozen = [k for k, v in ts.model.named_parameters()
                  if not v.requires_grad]
        assert frozen and all(k.startswith("actor_tiny.backbone")
                              for k in frozen), frozen
        assert not set(frozen) & set(ts.adam["m"])
        ts, _ = trainer.train_epoch(ts)
        after = dict(ts.model.named_parameters())
        assert all(torch.equal(before[k], after[k]) for k in frozen)
        assert not torch.equal(before["actor_tiny.fc.weight"],
                               after["actor_tiny.fc.weight"])

        count = harness.load_file(
            harness.HERE / "counts" / "encoders" / "tiny.py", "c")
        for name, want in (("tiny", 2 * count.forward_flops(212, 120, 3)
                            / count.PEAK), ("nocount", None)):
            model = types.SimpleNamespace(
                image_encoder=name, encoder=ts.model.actor_tiny,
                actor_mlp=ts.model.actor_mlp)
            prog = types.SimpleNamespace(cfg=trainer.cfg, num_envs=4)
            acct = train.Work(prog, types.SimpleNamespace(model=model))
            x = torch.zeros(3, 1, 212, 120)
            with torch.no_grad():
                model.encoder(x)
            model.encoder(x)
            acct.remove()
            assert acct.least.get(name) == want, (name, acct.least)
            ctx = {{"least": acct.least, "trace": types.SimpleNamespace(
                events=[(0.0, 5.0, "tiny_kernel")])}}
            got = _common.roofline(ctx, name, names=("tiny_kernel",))
            assert (got is None) == (want is None), got
        print("ok")
        """)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), (
        out.stdout[-2000:], out.stderr[-4000:])
