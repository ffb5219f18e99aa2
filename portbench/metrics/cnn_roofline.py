"""The CNN encoder's convolutions (their MACs at the bf16 peak) over the device time of cuDNN's conv kernels and layout copies, in %."""
from portbench.metrics import _common


def read(ctx):
    return _common.roofline(ctx, "cnn")
