"""B6, csrc/render_process.cu: each render's least time on the records left after culling, over the device time, in %."""
from portbench.metrics import _common


def read(ctx):
    return _common.roofline(ctx, "render_kernel")
