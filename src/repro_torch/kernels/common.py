"""Shared kernel machinery: device dispatch and the nvcc build.

Dispatch follows the device of the inputs, with no environment variable and
no ``auto``: tensors on the CPU take a kernel's plain PyTorch version;
tensors on a CUDA device launch the hand-written kernel, and a kernel that
does not build or launch raises.  Nothing falls back.

Kernels are CUDA C++ sources with a plain C interface under each package's
``csrc/``.  ``load_library`` compiles them with ``nvcc`` for ``sm_90a`` at
first use into ``_build/`` (listed in ``.gitignore``), keyed by a hash of
the sources and flags, so an edited source is rebuilt, and loads the shared
library with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# wall seconds each library took to build, and the compiler's report
# (registers, shared memory, spills per kernel); absent for a library that
# was already built
build_seconds: Dict[str, float] = {}
build_logs: Dict[str, str] = {}


def next_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device, False when every one
    lies on the CPU; mixed devices raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"inputs on mixed or unsupported devices: {sorted(kinds)}")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build_library(name: str, sources: Sequence[Path]) -> Path:
    """Compile ``sources`` into a shared library unless the same build
    exists; returns its path, named by a hash of the sources and the
    flags.  Raises with the compiler's output on a failed build."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(Path(src).read_bytes())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}-{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)          # atomic: a reader never sees half a .so
    build_seconds[name] = time.monotonic() - t0
    build_logs[name] = proc.stdout + proc.stderr
    return out


def load_library(name: str, sources: Sequence[Path]) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library, once per process.
    Libraries of different kernels build concurrently from threads."""
    lib = _libs.get(name)
    if lib is None:
        path = build_library(name, sources)
        with _lock:
            lib = _libs.setdefault(name, ctypes.CDLL(str(path)))
    return lib

