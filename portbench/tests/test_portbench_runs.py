"""What a run may load and when it refuses: no JAX and no JAX package in
the process; the reference imports nothing of the program; no card, too
few cards, or a checkout that holds only the benchmark means no result."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


def _python(code: str, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_no_jax_and_no_jax_package():
    """A tiny CPU run of every cell, then the modules held, compared by
    whole top-level name (the port's name begins with the JAX
    package's)."""
    out = _python(
        "import sys; sys.path.insert(0, '.')\n"
        "from portbench.tests import _tiny\n"
        "from portbench import harness\n"
        "for c in ('hovering.train', 'hovering.sim'): _tiny.run(c)\n"
        "import json; print(json.dumps(harness.banned_modules()))\n"
        "print('airgym_tpu_torch' in sys.modules)")
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-2]) == [] and lines[-1] == "True"


def test_the_reference_imports_nothing_of_the_program():
    out = _python(
        "import sys, torch; sys.path.insert(0, '.')\n"
        "from portbench.reference import train, sim, compare\n"
        "from portbench.tests import _tiny\n"
        "w = _tiny.cell('hovering.train')\n"
        "train.follow(w['config_file']['params'], 7, 1, "
        "torch.device('cpu'))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'airgym_tpu_torch', 'airgym_tpu', 'jax'}))")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _run(cwd, extra_env=None, workload="hovering.sim"):
    env = dict(os.environ, **(extra_env or {}))
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=900)


def test_no_card_no_result():
    out = _run(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_too_few_cards_refused():
    from portbench import harness
    with pytest.raises(SystemExit):
        harness.require_cards(torch.cuda.device_count() + 1
                              if torch.cuda.is_available() else 1)


@pytest.mark.cuda
def test_one_card_for_a_cell_over_ranks_gives_no_result():
    """On the card: the four-card cell with one card visible."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = _run(ROOT, {"CUDA_VISIBLE_DEVICES": "0"}, "planning.train.4gpu")
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


@pytest.mark.cuda
def test_benchmark_alone_gives_no_result(tmp_path):
    """On the card: a checkout holding only BENCHMARK.json and the
    benchmark's files has no program to measure."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_trace_reading_names_gaps_when_a_marker_is_missing():
    """A profiled stretch whose first marker kernel the profiler dropped
    still names each idle gap by the span the host was in."""
    from portbench import trace
    k = "void at::cuda::spin_kernel(long)"
    events = [(10, 11, k), (20, 30, "a"), (40, 41, k), (50, 60, "b"),
              (70, 71, k), (90, 95, "c")]
    r = trace.Reading(events, ["start", "rollout", "GAE", "update"], 1.0)
    gaps = dict(r.idle_gaps())
    assert gaps == {"rollout": pytest.approx(20e-6),
                    "GAE": pytest.approx(30e-6)}
    assert r.busy_s() == pytest.approx(25e-6)
