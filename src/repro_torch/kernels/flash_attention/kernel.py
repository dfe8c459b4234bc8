"""Wrapper of the Hopper flash-attention forward kernel (``csrc/flash_fwd.cu``).

Replaces ``flash_attention_pallas`` (``src/repro/kernels/flash_attention/
kernel.py:95``).  The CUDA source is compiled with ``nvcc`` for ``sm_90a``
at first use (``kernels/common.load_library``) and called through its
plain C interface with ``ctypes`` on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from ..common import load_library

SOURCES = (Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu",)
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the kernel in this process; a run sets it to 0 and reads it
# to show that a path went through the kernel
launches = 0


def _lib() -> ctypes.CDLL:
    lib = load_library("flash_fwd", SOURCES)
    fn = lib.flash_fwd
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                       ctypes.c_float, ci, ci, ci, ci, vp]
        fn.restype = ci
        lib.flash_fwd_error_string.argtypes = [ci]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel library."""
    _lib()


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: Optional[int],
                         scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, Hq, T, D), k/v: (B, Hkv, S, D) CUDA tensors, contiguous, of
    one dtype (f32 or bf16), D in {32, 64, 128}.  Returns ``(out in
    q.dtype, lse f32 (B, Hq, T))``."""
    global launches
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}, the kernel needs CUDA")
        if t.device != q.device:
            raise ValueError("q, k, v lie on different devices")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-d, got {tuple(t.shape)}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype} not supported: f32 or bf16")
    b, hq, t, d = q.shape
    bk, hkv, s, dk = k.shape
    if v.shape != k.shape or bk != b or dk != d:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not agree")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, hq, hkv, t, s, d, float(scale), int(causal),
        int(window is not None), int(window or 0), _DTYPES[q.dtype], stream)
    if status != 0:
        msg = lib.flash_fwd_error_string(status).decode()
        raise RuntimeError(f"flash_fwd launch failed: {msg} ({status})")
    launches += 1
    return out, lse
