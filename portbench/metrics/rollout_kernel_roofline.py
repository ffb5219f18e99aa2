"""B2, csrc/fused_rollout.cu: the launches' least time over their device time, in %."""
from portbench.metrics import _common


def read(ctx):
    return _common.roofline(ctx, "rollout_kernel")
