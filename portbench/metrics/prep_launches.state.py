"""CUDA runtime launches per epoch inside the program's ``gae``, ``stats``
and ``dataset`` spans together: the work between the rollout kernel and
the update kernel (program_trace.py)."""
from portbench import program_trace


def read(ctx):
    r = program_trace.reading(ctx)
    if r is None:
        return None
    return sum(r.launches(name) for name in ("gae", "stats", "dataset"))
