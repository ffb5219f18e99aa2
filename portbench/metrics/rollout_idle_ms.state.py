"""Idle device ms per epoch in the program's ``rollout`` span and below
(the fused rollout's host side, ``bookkeeping`` included)
(program_trace.py)."""
from portbench import program_trace


def read(ctx):
    r = program_trace.reading(ctx)
    return None if r is None else r.idle_ms("rollout")
