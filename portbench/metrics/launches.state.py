"""CUDA runtime launches per epoch inside the program's ``epoch`` span, the
benchmark's marker launches left out (program_trace.py)."""
from portbench import program_trace


def read(ctx):
    r = program_trace.reading(ctx)
    return None if r is None else r.launches("epoch")
