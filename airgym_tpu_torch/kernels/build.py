"""Build the port's CUDA kernels with ``nvcc`` at first use and bind them
with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/torch_kernels/lib<name>-<hash>.so``
at the repository root (the hash covers the sources and flags, so an edit
rebuilds). The sources have a plain C interface, so the build needs only
the CUDA toolkit: ``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared -Xcompiler -fPIC``. Every pointer and the stream cross as
``c_void_p``; each entry point returns a ``cudaError_t``, and a non-zero
one raises. A source may add flags of its own (``extra_flags``), such as
``-fmad=false`` for a kernel whose plain version must round alike.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build with the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def find_cuobjdump():
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and os.path.exists(cand):
            return cand
    return None


def sass(kernel) -> Dict[str, list]:
    """The SASS of each kernel function in ``kernel``'s built library
    (``cuobjdump -sass``): {function name: [(address, instruction)]}, NOPs
    left out. Empty without cuobjdump."""
    tool = find_cuobjdump()
    if tool is None:
        return {}
    text = subprocess.run([tool, "-sass", str(kernel.so_path())],
                          capture_output=True, text=True, timeout=120).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if name and m and "NOP" not in m.group(2).split():
            funcs[name].append((int(m.group(1), 16), m.group(2)))
    return funcs


class CudaKernel:
    """One CUDA source built into its own shared library.

    ``launches`` counts the CUDA kernel launches the wrappers made through
    this library, by variant (a task, an observation width); nothing else
    touches it.
    """

    def __init__(self, name: str, entry_points: Dict[str, list],
                 extra_flags: Iterable[str] = ()):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.entry_points = entry_points
        self.extra_flags = list(extra_flags)
        self.launches = collections.Counter()
        self.build_log = ""
        self._lib = None

    def flags(self) -> list:
        """nvcc flags, read at build time (so the module's NVCC_FLAGS
        count) plus this source's own."""
        return NVCC_FLAGS + self.extra_flags

    def so_path(self) -> Path:
        h = hashlib.sha256(" ".join(self.flags()).encode())
        # the headers beside the source, which its #include finds first,
        # and the tree's
        heads = set(self.source.parent.glob("*.cuh")) | set(CSRC.glob("*.cuh"))
        for src in [self.source] + sorted(heads):
            h.update(src.name.encode())
            h.update(src.read_bytes())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def start_build(self):
        """Start nvcc unless the library is built; returns a handle for
        ``finish_build`` or None."""
        out = self.so_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *self.flags(), "-I", str(CSRC), "-o", str(tmp),
               str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, out

    def finish_build(self, handle) -> None:
        if handle is None:
            return
        proc, tmp, out = handle
        log, _ = proc.communicate()
        self.build_log = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source.name} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            self.finish_build(self.start_build())
            self._bind(self.so_path())
        return self._lib

    def _bind(self, path) -> None:
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in self.entry_points.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.airgym_error_string.argtypes = [ctypes.c_int]
        lib.airgym_error_string.restype = ctypes.c_char_p
        self._lib = lib

    def call(self, fn: str, *args) -> None:
        lib = self.lib()
        err = getattr(lib, fn)(*args)
        if err != 0:
            msg = lib.airgym_error_string(err).decode()
            raise RuntimeError(f"{self.name}.{fn}: CUDA error {err} ({msg})")


def build_emulated(kernel: CudaKernel, out: Path) -> CudaKernel:
    """Tests only: ``kernel``'s source compiled for the CPU with g++ into
    ``out`` against ``csrc/cuda_emu.h``, which emulates the CUDA the
    port's kernels use (one std::thread per CUDA thread), bound as a new
    CudaKernel with the same entry points. Raises without g++."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the emulated build compiles the "
                           "kernel source for the CPU")
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-ffp-contract=off", "-include", str(CSRC / "cuda_emu.h"),
                    "-x", "c++", str(kernel.source), "-o", str(out),
                    "-lpthread"], check=True, capture_output=True, timeout=300)
    emu = CudaKernel(kernel.name, kernel.entry_points)
    emu._bind(out)
    return emu


def build_all(kernels: Iterable[CudaKernel]) -> float:
    """Build every kernel's library at once (one nvcc per source, all
    started together); returns the wall seconds."""
    t0 = time.perf_counter()
    kernels: List[CudaKernel] = list(kernels)
    handles = [k.start_build() for k in kernels]
    for k, h in zip(kernels, handles):
        k.finish_build(h)
    for k in kernels:
        k.lib()
    return time.perf_counter() - t0
