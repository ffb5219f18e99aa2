"""The reference's device and float32 matmul precision: TF32 off for both
cuBLAS and cuDNN, as the configurations state (TF32 keeps about three
decimal digits)."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` means ``cuda``; turns TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda" if device is None else device)
