"""Host-blocking CUDA runtime calls per ``rollout_fused`` call inside its
span (program_trace.py)."""
from portbench import program_trace


def read(ctx):
    r = program_trace.reading(ctx, "hovering.sim")
    return None if r is None else r.syncs("rollout_fused")
