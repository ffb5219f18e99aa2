"""Idle device ms per epoch in the plain update's ``adam`` spans (clip,
Adam step, mu / sigma write-back) (program_trace.py)."""
from portbench import program_trace


def read(ctx):
    r = program_trace.reading(ctx)
    return None if r is None else r.idle_ms("adam")
