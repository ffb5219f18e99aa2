"""ctypes bindings for the host-side C++ PX4 cascade (counterpart of
airgym_tpu/control/native.py; source ``csrc/px4_cascade.cpp``).

The controller the reference runs as the external C++ ``rlPx4Controller``
(reference airgym/envs/base/hovering.py:10): the cascade of
``control/px4.py`` in plain C++, for (a) AirGym-Real-style onboard
deployment without PyTorch or a GPU, and (b) a golden cross-check of
``control/px4.run`` (the tests hold the two to float32 round-off in every
mode). It is host-side by design: numpy in and out, CPU tensors accepted.

The gains are compiled into the library: ``struct Gains`` in the source
holds ``px4.CascadeGains()``'s defaults, and the C ABI takes no gains
argument, so a cascade with other gains runs only in ``px4.run``.

The library builds at first use with ``g++ -O3 -shared -fPIC -std=c++17``
(no ``-ffast-math``: the float32 roundings are the point) into
``build/native/libpx4cascade-<hash>.so`` at the repository root, keyed by
a hash of the source and the flags, as ``kernels/build.py`` keys the CUDA
kernels; nothing is written beside the source. A failed build raises.
The API is the reference's ParallelXControl classes:

    ctl = ParallelControl("rate", num_envs)
    cmds = ctl.update(root_states, actions, dt=0.01)   # [n, 4] in [0, 1]
    ctl.reset(mask, quats_xyzw)
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from airgym_tpu_torch.control import px4

MODES = {"pos": 0, "vel": 1, "atti": 2, "rate": 3, "prop": 4}
SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "px4_cascade.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

# per-env controller memory, the C struct CState: rate_int, prev_rate,
# vel_int, prev_vel_err (3 floats each) and yaw_sp
STATE_FLOATS = 13


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libpx4cascade-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this source's build exists; returns its
    path. Raises without g++ or when g++ fails."""
    out = lib_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native PX4 cascade builds "
                           "from csrc/px4_cascade.cpp with g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name} (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


_cached_lib: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _cached_lib
    if _cached_lib is None:
        lib = ctypes.CDLL(str(build()))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.cascade_run.argtypes = [
            ctypes.c_int, ctypes.c_int, f32p, f32p, ctypes.c_float,
            f32p, f32p]
        lib.cascade_run.restype = None
        lib.cascade_reset.argtypes = [ctypes.c_int, u8p, f32p, f32p]
        lib.cascade_reset.restype = None
        _cached_lib = lib
    return _cached_lib


def _host(x, dtype, shape, name: str) -> np.ndarray:
    """``x`` (numpy or a CPU tensor) as a C-contiguous array of ``dtype``
    and ``shape``; raises on another shape or a device tensor."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(f"{name}: the native cascade is host-side; "
                             f"copy the tensor to the CPU first")
        x = x.detach().numpy()
    a = np.ascontiguousarray(x, dtype=dtype)
    if a.shape != shape:
        raise ValueError(f"{name}: shape {a.shape}, expected {shape}")
    return a


class ParallelControl:
    """Batched cascade with persistent per-env state (reference
    ParallelPosControl / VelControl / AttiControl / RateControl)."""

    def __init__(self, mode: str, num_envs: int):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; expected "
                             f"{tuple(MODES)}")
        self.mode = mode
        self.num_envs = num_envs
        self.state = np.zeros((num_envs, STATE_FLOATS), dtype=np.float32)

    def reset(self, mask, quats_xyzw) -> None:
        """Zero the integrators of the masked envs and re-anchor their yaw
        setpoint at the given quaternions' yaw."""
        n = self.num_envs
        _lib().cascade_reset(n, _host(mask, np.uint8, (n,), "mask"),
                             _host(quats_xyzw, np.float32, (n, 4),
                                   "quats_xyzw"),
                             self.state)

    def update(self, root_states, actions, dt: float = 0.01) -> np.ndarray:
        """root_states [n, 13] (xyzw quats) and the mode's actions [n, 4]
        ([n, 5] in atti) -> rotor commands [n, 4] in [0, 1]."""
        n = self.num_envs
        cmds = np.zeros((n, 4), dtype=np.float32)
        _lib().cascade_run(
            MODES[self.mode], n,
            _host(root_states, np.float32, (n, 13), "root_states"),
            _host(actions, np.float32, (n, px4.num_actions(self.mode)),
                  "actions"),
            float(dt), self.state, cmds)
        return cmds

    def state_as_cascade_state(self, device=None) -> px4.CascadeState:
        """A copy of the native state as the port's ``px4.CascadeState``
        on ``device`` (default the CPU)."""
        s = torch.from_numpy(self.state.copy()).to(device or "cpu")
        return px4.CascadeState(rate_int=s[:, 0:3], prev_rate=s[:, 3:6],
                                vel_int=s[:, 6:9], prev_vel_err=s[:, 9:12],
                                yaw_sp=s[:, 12])
