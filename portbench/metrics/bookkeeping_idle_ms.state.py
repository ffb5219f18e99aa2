"""Idle device ms per epoch in the fused rollout's ``bookkeeping`` span
(the episode-bookkeeping loop and the env-state rebuild)
(program_trace.py)."""
from portbench import program_trace


def read(ctx):
    r = program_trace.reading(ctx)
    return None if r is None else r.idle_ms("bookkeeping")
