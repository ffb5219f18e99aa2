"""Mean ms of trainer.update over the window's epochs, a sync either side (the plain trainer's update)."""
from portbench.metrics import _common


def read(ctx):
    return _common.span_ms(ctx, "update")
