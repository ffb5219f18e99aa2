"""B1, csrc/fused_hovering.cu: the launches' least time (resets counted as a lower bound) over their device time, in %."""
from portbench.metrics import _common


def read(ctx):
    return _common.roofline(ctx, "env_kernel")
