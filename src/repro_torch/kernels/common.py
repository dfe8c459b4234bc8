"""Shared kernel machinery: device dispatch and the nvcc build.

Dispatch follows the device of the inputs, with no environment variable and
no ``auto``: tensors on the CPU take a kernel's plain PyTorch version;
tensors on a CUDA device launch the hand-written kernel, and a kernel that
does not build or launch raises.  Nothing falls back.  Tensors on the
``meta`` device (which hold no values) get empty outputs of the kernel's
shapes and dtypes: that is how a step is traced abstractly
(``launch/opcount.py``).  Any other device raises.

Each kernel call, launched or traced on ``meta``, passes its work (FLOPs
and bytes, the counts its bound in ``PERF.md`` uses) to ``record_cost``,
which hands it to every sink in ``cost_sinks``: an active
``launch.opcount.OpCounter`` adds one.

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
from typing import Callable, Dict, List, Sequence

import torch

BUILD_DIR = Path(__file__).resolve().parent / "_build"
# the f32 <-> bf16 helpers the sources that take both types include
CONVERT_HEADER = Path(__file__).resolve().parent / "csrc" / "convert.cuh"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# wall seconds each library took to build, and the compiler's report
# (registers, shared memory, spills per kernel); absent for a library that
# was already built
build_seconds: Dict[str, float] = {}
build_logs: Dict[str, str] = {}
# the shared library each loaded name came from
library_paths: Dict[str, Path] = {}


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


def on_meta(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the ``meta`` device."""
    return {t.device.type for t in tensors} == {"meta"}


# callables (kernel name, flops, bytes) that each kernel call reports to
cost_sinks: List[Callable[[str, float, float, tuple], None]] = []


def record_cost(name: str, flops: float, nbytes: float, *,
                reads: tuple = ()) -> None:
    """Pass one kernel call's work and the tensors it reads (None among
    them skipped) to every sink in ``cost_sinks``."""
    for sink in cost_sinks:
        sink(name, flops, nbytes, reads)


def check_tensor(name: str, t: torch.Tensor, shape, dtypes, device) -> None:
    """Raise ValueError unless ``t`` lies on CUDA ``device``, has one of
    ``dtypes``, has ``shape`` and is contiguous: what a kernel wrapper
    checks before it passes a pointer."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}, the kernel needs CUDA")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, not {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}; the kernel takes "
                         f"{sorted(map(str, dtypes))}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build_library(name: str, sources: Sequence[Path],
                  headers: Sequence[Path] = ()) -> Path:
    """Compile ``sources`` into a shared library unless the same build
    exists; returns its path, named by a hash of the sources, the headers
    they include and the flags.  Raises with the compiler's output on a
    failed build."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sources, *headers):
        h.update(Path(src).read_bytes())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}-{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)          # atomic: a reader never sees half a .so
    build_seconds[name] = time.monotonic() - t0
    build_logs[name] = proc.stdout + proc.stderr
    return out


def load_library(name: str, sources: Sequence[Path],
                 headers: Sequence[Path] = ()) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library, once per process.
    Libraries of different kernels build concurrently from threads."""
    lib = _libs.get(name)
    if lib is None:
        path = build_library(name, sources, headers)
        with _lock:
            lib = _libs.setdefault(name, ctypes.CDLL(str(path)))
            library_paths.setdefault(name, path)
    return lib

