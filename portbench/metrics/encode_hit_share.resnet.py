"""Share of the plain update's Adam steps that ran the frozen encoder's
trained head alone on its kept input (the program's ``encode_hit``
spans over its ``minibatch`` spans), in % (program_trace.py); nothing
where the program has no ``encode_hit`` span."""
from portbench import program_trace


def read(ctx):
    r = program_trace.reading(ctx)
    if r is None or not r.counts.get("encode_hit") \
            or not r.counts.get("minibatch"):
        return None
    return 100.0 * r.counts["encode_hit"] / r.counts["minibatch"]
