"""airgym_tpu_torch: the PyTorch / CUDA (H100) port of airgym_tpu.

The module tree mirrors ``airgym_tpu`` so that each file has a counterpart
there. Plain tensor code is PyTorch; the two kernels of the default
Hovering PPO trainer (the fused rollout and the fused update) are CUDA C++
under ``csrc/``, built with ``nvcc`` at first use (``kernels/build.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU they raise instead of falling back (``device.resolve``).
"""
from airgym_tpu_torch.device import resolve  # noqa: F401

__version__ = "0.1.0"
