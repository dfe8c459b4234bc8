"""Wrapper of the Hopper RWKV-6 recurrence kernel (``csrc/rwkv6.cu``), K6.

Replaces ``rwkv6_pallas`` (``src/repro/kernels/rwkv6/kernel.py:86``).  The
CUDA source is compiled with ``nvcc`` for ``sm_90a`` at first use
(``kernels/common.load_library``) and called through its plain C interface
with ``ctypes`` on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from ..common import check_tensor, load_library

SOURCES = (Path(__file__).resolve().parent / "csrc" / "rwkv6.cu",)
HEAD_DIMS = (16, 32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches in this process; a run sets it to 0 and reads it to show that a
# path went through the kernel
launches = 0


def _lib() -> ctypes.CDLL:
    lib = load_library("rwkv6", SOURCES)
    fn = lib.rwkv6_fwd
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 8 + [ci] * 5 + [vp]
        fn.restype = ci
        lib.rwkv6_error_string.argtypes = [ci]
        lib.rwkv6_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel's library."""
    _lib()


def rwkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v: (B, H, T, D) of one dtype (f32 or bf16), log_w: (B, H, T, D)
    f32, u: (H, D) f32, s0: (B, H, D, D) f32, all contiguous on one CUDA
    device, D in {16, 32, 64}.  Returns ``(o in v.dtype, sT f32)``."""
    global launches
    if r.dim() != 4:
        raise ValueError(f"r must be (B, H, T, D), got {tuple(r.shape)}")
    b, h, t, d = r.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if r.dtype not in _DTYPES:
        raise ValueError(f"dtype {r.dtype} not supported: f32 or bf16")
    for name, x in (("r", r), ("k", k), ("v", v)):
        check_tensor(name, x, (b, h, t, d), (r.dtype,), r.device)
    check_tensor("log_w", log_w, (b, h, t, d), (torch.float32,), r.device)
    check_tensor("u", u, (h, d), (torch.float32,), r.device)
    check_tensor("s0", s0, (b, h, d, d), (torch.float32,), r.device)
    o = torch.empty_like(v)
    if t == 0 or b * h == 0:
        return o, s0.clone()
    sT = torch.empty_like(s0)
    lib = _lib()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    status = lib.rwkv6_fwd(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                           log_w.data_ptr(), u.data_ptr(), s0.data_ptr(),
                           o.data_ptr(), sT.data_ptr(), b, h, t, d,
                           _DTYPES[r.dtype], stream)
    if status != 0:
        msg = lib.rwkv6_error_string(status).decode()
        raise RuntimeError(f"rwkv6 launch failed: {msg} ({status})")
    launches += 1
    return o, sT
