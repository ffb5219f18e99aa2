"""CUDA runtime launches per Adam step of the plain update: those inside
the program's ``update`` span over its ``minibatch`` spans, the
benchmark's marker launches left out (program_trace.py)."""
from portbench import program_trace


def read(ctx):
    r = program_trace.reading(ctx)
    if r is None or not r.counts.get("minibatch"):
        return None
    return r.launches("update") * r.roots / r.counts["minibatch"]
