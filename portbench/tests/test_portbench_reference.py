"""The plain reference against the port at a tiny size on the CPU, where
the port's kernels run their plain versions: every number reads 0."""
from __future__ import annotations

import pytest

from portbench import harness
from portbench.tests import _tiny


@pytest.mark.parametrize("name", ["hovering.train", "planning.train",
                                  "hovering.sim"])
def test_reference_agrees_with_the_port_on_cpu(name):
    w = _tiny.cell(name)
    res = _tiny.run(name, w=w)
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["numbers"]) == set(w["limits"])
    assert all(v == 0.0 for v in res["numbers"].values()), res["numbers"]
    assert harness.judge(res["numbers"], w["limits"])[0]
