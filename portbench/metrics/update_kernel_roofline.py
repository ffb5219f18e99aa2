"""B3, csrc/fused_update.cu: the launches' least time over their device time, in %."""
from portbench.metrics import _common


def read(ctx):
    return _common.roofline(ctx, "update_kernel")
