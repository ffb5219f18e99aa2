"""Mean ms of trainer.update over the window's epochs, a sync either side (the fused update)."""
from portbench.metrics import _common


def read(ctx):
    return _common.span_ms(ctx, "update")
