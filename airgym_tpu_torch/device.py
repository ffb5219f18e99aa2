"""Device resolution and float32 matmul precision for the port.

The JAX reference runs its matmuls at ``highest`` precision, so the port
turns TF32 off for both cuBLAS and cuDNN: TF32 keeps about three decimal
digits and would break float32 parity.
"""
from __future__ import annotations

import torch


def disable_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve(device=None) -> torch.device:
    """``None`` means ``cuda``. Raises when CUDA is asked for and absent:
    the port never falls back to the CPU on its own."""
    disable_tf32()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "airgym_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
