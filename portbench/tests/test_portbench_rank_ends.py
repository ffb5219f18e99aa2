"""A rank that dies or hangs partway ends the run over ranks with a
non-zero exit and no result line, within the traffic's deadline (two
gloo ranks on the CPU; rank 1 is killed, or stops answering, at the
window's first epoch boundary)."""
from __future__ import annotations

import pytest

from portbench.tests import _ranks

# a short deadline and collective timeout for the rehearsal
TRAFFIC = {"deadline_s": 40, "collective_timeout_s": 15}


@pytest.mark.parametrize("fault", ["rank_dies", "rank_hangs"])
def test_a_rank_that_dies_or_hangs_ends_the_run(fault):
    out, took = _ranks.run(seed=2 ** 31 + 17, seconds=2.0, fault=fault,
                           traffic=TRAFFIC)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
    assert took < 2.0 + TRAFFIC["deadline_s"] + 30, took
