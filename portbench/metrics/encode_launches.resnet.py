"""CUDA runtime launches per epoch inside the program's ``encode`` spans
(the ResNet-18 encoder's calls in the rollout and in each minibatch's
loss) (program_trace.py); nothing where the program has no ``encode``
span."""
from portbench import program_trace


def read(ctx):
    r = program_trace.reading(ctx)
    if r is None or not r.counts.get("encode"):
        return None
    return r.launches("encode")
