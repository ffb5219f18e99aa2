"""Host-blocking CUDA runtime calls per epoch inside the program's
``epoch`` span (program_trace.py)."""
from portbench import program_trace


def read(ctx):
    r = program_trace.reading(ctx)
    return None if r is None else r.syncs("epoch")
