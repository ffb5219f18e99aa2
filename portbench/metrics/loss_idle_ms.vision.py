"""Idle device ms per epoch in the plain update's ``loss`` spans (slices,
image window, forward and loss) (program_trace.py)."""
from portbench import program_trace


def read(ctx):
    r = program_trace.reading(ctx)
    return None if r is None else r.idle_ms("loss")
