"""Counter-based hash RNG, the plain version of ``csrc/common.cuh``'s.

uint32 arithmetic carried in int64 and masked to 32 bits, so the bits
equal the Pallas kernels' and the CUDA kernels' exactly. The rollout
kernels (``ops/fused_hovering.py``, ``ops/fused_rollout.py``) and the
render kernel (``render/raycast.py``) draw from it.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def mulmod(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32) without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def mix(x):
    """murmur3-style 32-bit finalizer on int64 values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = mulmod(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mulmod(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def make_uniform(base_key, lanes: torch.Tensor):
    """Counter-based uniform draws in [0, 1): ``base_key`` is an int or an
    int64 tensor broadcastable to ``lanes`` (the draw's lane index). Each
    call advances the draw counter, starting at 1."""
    counter = [0]
    key_part = mulmod(base_key, 0x9E3779B9)
    lane_part = (lanes + 0x85EBCA6B) & M32

    def uniform():
        counter[0] += 1
        bits = mix(key_part ^ lane_part ^ mulmod(counter[0], 0xC2B2AE35))
        return (bits >> 1).to(torch.float32) * (1.0 / 2147483648.0)

    return uniform
