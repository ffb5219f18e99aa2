"""Share of the profiled stretch in which no device event ran, in %."""
from portbench.metrics import _common


def read(ctx):
    return _common.idle_pct(ctx)
