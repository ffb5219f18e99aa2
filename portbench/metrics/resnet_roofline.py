"""The ResNet-18 backbone's convolutions (their MACs at the float32 peak,
``counts/encoders/resnet.py``) over the device time of cuDNN's
convolution kernels, in %.

The kernels the cell launches on the H100 in float32 with TF32 off, read
off a traced run (cuDNN 9.2, torch 2.11): the implicit-GEMM FFMA forward
``sm80_xmma_fprop_implicit_gemm_f32f32_...`` (most convs),
``implicit_convolve_sgemm`` (the 7 x 7 stem) and, for a few 3 x 3 convs,
the FFT algorithm: ``fft2d_r2c_*`` / ``fft2d_c2r_*``, its complex GEMM
``sm80_xmma_gemm_cf32cf32_...`` and ``flip_filter``. The FFT does fewer
operations than the MACs counted, so its convs read above their own
share; all together read under 100%."""
from portbench.metrics import _common

NAMES = ("fprop", "implicit_convolve", "fft2d", "gemm_cf32", "flip_filter")


def read(ctx):
    return _common.roofline(ctx, "resnet", NAMES)
