"""Idle device ms per epoch in the program's ``stats`` span (the running
obs / value stats and the advantage normalization) (program_trace.py)."""
from portbench import program_trace


def read(ctx):
    r = program_trace.reading(ctx)
    return None if r is None else r.idle_ms("stats")
