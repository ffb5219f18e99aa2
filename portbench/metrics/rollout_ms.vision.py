"""Mean ms of trainer.rollout over the window's epochs, a sync either side (the plain trainer's camera rollout)."""
from portbench.metrics import _common


def read(ctx):
    return _common.span_ms(ctx, "rollout")
