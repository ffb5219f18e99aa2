"""The whole step's counted work at each part's peak over the stretch's wall time, in %."""
from portbench.metrics import _common


def read(ctx):
    return _common.mfu(ctx)
