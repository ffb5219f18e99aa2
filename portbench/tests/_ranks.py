"""A run of the cell over ranks on the CPU, as ``run.py`` makes it: two
gloo ranks at the tiny sizes, the harness's look for cards skipped, in a
process of its own (a rank that dies or hangs ends the whole run)."""
from __future__ import annotations

import subprocess
import sys
import textwrap
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CELL = "planning.train.4gpu"


def run(seed: int, seconds: float = 0.5, fault=None, traffic=None):
    """(CompletedProcess, seconds it took) of ``run.py`` on the CPU."""
    code = textwrap.dedent(f"""
        import functools, sys, torch
        sys.path.insert(0, {str(ROOT)!r})
        from portbench import harness, run
        from portbench.tests import _tiny
        w = _tiny.cell({CELL!r})
        w["traffic_file"].update({traffic or {}!r})
        harness.cell = lambda name, sp=None: w
        harness.require_cards = lambda n: None
        driver = harness.driver("train_ranks")
        driver.run = functools.partial(driver.run, dev=torch.device("cpu"),
                                       fault={fault!r})
        sys.exit(run.main(["--workload", {CELL!r}, "--seed", "{seed}",
                           "--seconds", "{seconds}", "--trace", "0"]))
        """)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    return out, time.perf_counter() - t0
