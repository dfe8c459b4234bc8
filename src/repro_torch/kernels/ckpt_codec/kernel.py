"""Wrappers of the Hopper checkpoint-codec kernels (``csrc/codec.cu``).

Replace ``quantize_pallas``, ``quantize_delta_pallas`` and
``dequantize_pallas`` (``src/repro/kernels/ckpt_codec/kernel.py:54, :74,
:98``).  The CUDA source is compiled with ``nvcc`` for ``sm_90a`` at first
use (``kernels/common.load_library``) and called through its plain C
interface with ``ctypes`` on PyTorch's current stream.  Each wrapper takes
the flattened ``(nb, BLOCK)`` layout that ``ops`` builds.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from ..common import check_tensor, load_library
from .blocks import BLOCK

SOURCES = (Path(__file__).resolve().parent / "csrc" / "codec.cu",)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# launches of each kernel in this process; a run sets them to 0 and reads
# them to show that a path went through the kernels
launches: Dict[str, int] = {"quantize": 0, "quantize_delta": 0,
                            "dequantize": 0}


def _lib() -> ctypes.CDLL:
    lib = load_library("ckpt_codec", SOURCES)
    if lib.ckpt_quantize.argtypes is None:
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ckpt_quantize.argtypes = [vp, vp, vp, ll, ci, vp]
        lib.ckpt_quantize_delta.argtypes = [vp, vp, vp, vp, vp, ll, ci, vp]
        lib.ckpt_dequantize.argtypes = [vp, vp, vp, ll, ci, vp]
        for fn in (lib.ckpt_quantize, lib.ckpt_quantize_delta,
                   lib.ckpt_dequantize):
            fn.restype = ci
        lib.ckpt_codec_error_string.argtypes = [ci]
        lib.ckpt_codec_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel library."""
    _lib()


def _check(name: str, t: torch.Tensor, dtypes, nb: int, device) -> None:
    check_tensor(name, t, (nb, BLOCK), dtypes, device)
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def _launch(fn_name: str, *args) -> None:
    lib = _lib()
    status = getattr(lib, fn_name)(*args)
    if status != 0:
        msg = lib.ckpt_codec_error_string(status).decode()
        raise RuntimeError(f"{fn_name} launch failed: {msg} ({status})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def quantize_cuda(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (nb, BLOCK) f32/bf16/f16 on CUDA -> (codes int8 (nb, BLOCK),
    scales f32 (nb, 1))."""
    nb = x.shape[0] if x.dim() == 2 else -1
    _check("x", x, _DTYPES, nb, x.device)
    q = torch.empty((nb, BLOCK), dtype=torch.int8, device=x.device)
    s = torch.empty((nb, 1), dtype=torch.float32, device=x.device)
    if nb == 0:
        return q, s
    _launch("ckpt_quantize", x.data_ptr(), q.data_ptr(), s.data_ptr(), nb,
            _DTYPES[x.dtype], _stream(x))
    launches["quantize"] += 1
    return q, s


def quantize_delta_cuda(x: torch.Tensor, prev_q: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (nb, BLOCK) float, prev_q: (nb, BLOCK) int8, both on one CUDA
    device -> (delta int8, scales f32 (nb, 1), codes int8)."""
    nb = x.shape[0] if x.dim() == 2 else -1
    _check("x", x, _DTYPES, nb, x.device)
    _check("prev_q", prev_q, (torch.int8,), nb, x.device)
    d = torch.empty((nb, BLOCK), dtype=torch.int8, device=x.device)
    s = torch.empty((nb, 1), dtype=torch.float32, device=x.device)
    q = torch.empty((nb, BLOCK), dtype=torch.int8, device=x.device)
    if nb == 0:
        return d, s, q
    _launch("ckpt_quantize_delta", x.data_ptr(), prev_q.data_ptr(),
            d.data_ptr(), s.data_ptr(), q.data_ptr(), nb, _DTYPES[x.dtype],
            _stream(x))
    launches["quantize_delta"] += 1
    return d, s, q


def dequantize_cuda(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """q: (nb, BLOCK) int8, scale: (nb, 1) f32, both on one CUDA device ->
    (nb, BLOCK) of ``dtype`` (f32/bf16/f16): codes * scale in f32, then
    cast."""
    nb = q.shape[0] if q.dim() == 2 else -1
    _check("q", q, (torch.int8,), nb, q.device)
    if scale.shape != (nb, 1) or scale.dtype != torch.float32 \
            or scale.device != q.device or not scale.is_contiguous():
        raise ValueError(f"scale must be contiguous f32 ({nb}, 1) on "
                         f"{q.device}, got {scale.dtype} "
                         f"{tuple(scale.shape)} on {scale.device}")
    if dtype not in _DTYPES:
        raise ValueError(f"output dtype {dtype} not supported")
    out = torch.empty((nb, BLOCK), dtype=dtype, device=q.device)
    if nb == 0:
        return out
    _launch("ckpt_dequantize", q.data_ptr(), scale.data_ptr(),
            out.data_ptr(), nb, _DTYPES[dtype], _stream(q))
    launches["dequantize"] += 1
    return out
