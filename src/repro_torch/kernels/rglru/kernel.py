"""Wrapper of the Hopper RG-LRU scan kernel (``csrc/rglru.cu``), K7.

Replaces ``rglru_pallas`` (``src/repro/kernels/rglru/kernel.py:58``).  The
CUDA source is compiled with ``nvcc`` for ``sm_90a`` at first use
(``kernels/common.load_library``) and called through its plain C interface
with ``ctypes`` on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from ..common import check_tensor, load_library

SOURCES = (Path(__file__).resolve().parent / "csrc" / "rglru.cu",)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches in this process; a run sets it to 0 and reads it to show that a
# path went through the kernel
launches = 0


def _lib() -> ctypes.CDLL:
    lib = load_library("rglru", SOURCES)
    fn = lib.rglru_fwd
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 5 + [ci] * 4 + [vp]
        fn.restype = ci
        lib.rglru_error_string.argtypes = [ci]
        lib.rglru_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel's library."""
    _lib()


def rglru_cuda(log_a: torch.Tensor, g: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """log_a: (B, T, D) f32, g: (B, T, D) f32 or bf16, h0: (B, D) f32 or
    None (zeros), all contiguous on one CUDA device.  Returns ``(h in
    g.dtype, h_final f32)``."""
    global launches
    if g.dim() != 3:
        raise ValueError(f"g must be (B, T, D), got {tuple(g.shape)}")
    b, t, d = g.shape
    check_tensor("g", g, (b, t, d), tuple(_DTYPES), g.device)
    check_tensor("log_a", log_a, (b, t, d), (torch.float32,), g.device)
    if h0 is not None:
        check_tensor("h0", h0, (b, d), (torch.float32,), g.device)
    h = torch.empty_like(g)
    if t == 0 or b * d == 0:
        return h, (torch.zeros((b, d), dtype=torch.float32, device=g.device)
                   if h0 is None else h0.clone())
    h_final = torch.empty((b, d), dtype=torch.float32, device=g.device)
    lib = _lib()
    stream = torch.cuda.current_stream(g.device).cuda_stream
    status = lib.rglru_fwd(log_a.data_ptr(), g.data_ptr(),
                           None if h0 is None else h0.data_ptr(),
                           h.data_ptr(), h_final.data_ptr(), b, t, d,
                           _DTYPES[g.dtype], stream)
    if status != 0:
        msg = lib.rglru_error_string(status).decode()
        raise RuntimeError(f"rglru launch failed: {msg} ({status})")
    launches += 1
    return h, h_final
