"""The ResNet-18 encoder's count (``models/resnet.ResNet18Encoder``, the
reference's ``plain/models/resnet.py``): the multiply-adds of its 20
convolutions and its ``fc``, worked out from the layer shapes at ``w`` x
``h`` (0.937 G an image at 212 x 120), at the float32 peak; the float32
images read once.

The backbone is frozen and runs under ``no_grad``: a call with gradients
on (the update's) is the same backbone forward and the ``fc``'s forward
and backward, three times its forward. Reductions, batch norms, ReLUs,
pools and adds are not counted."""
from portbench.counts import work

PEAK = work.PEAK_FP32

STEM = (1, 64, 7, 2)                  # in, out, kernel, stride
# (channels, stride of the first block) of each stage, two BasicBlocks each
STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))
FEATURES = 512
OUTPUT_DIM = 30


def _out(n: int, k: int, stride: int) -> int:
    """Output length of a conv or pool with padding k // 2."""
    return (n + 2 * (k // 2) - k) // stride + 1


def conv_macs(w: int, h: int) -> int:
    """Multiply-adds of the backbone's convolutions for one image."""
    cin, cout, k, s = STEM
    w, h = _out(w, k, s), _out(h, k, s)
    macs = w * h * cout * cin * k * k
    w, h = _out(w, 3, 2), _out(h, 3, 2)             # the max-pool
    cin = cout
    for cout, stride in STAGES:
        for block in range(2):
            s = stride if block == 0 else 1
            wo, ho = _out(w, 3, s), _out(h, 3, s)
            macs += wo * ho * cout * cin * 9            # conv1
            macs += wo * ho * cout * cout * 9           # conv2
            if s != 1 or cin != cout:
                macs += wo * ho * cout * cin            # downsample 1 x 1
            w, h, cin = wo, ho, cout
    return macs


def fc_macs() -> int:
    return FEATURES * OUTPUT_DIM


def forward_flops(w: int, h: int, images: int) -> float:
    return 2.0 * (conv_macs(w, h) + fc_macs()) * images


def train_flops(w: int, h: int, images: int) -> float:
    return (2.0 * conv_macs(w, h) + 3.0 * 2.0 * fc_macs()) * images


def nbytes(w: int, h: int, images: int) -> float:
    return 4.0 * images * w * h
