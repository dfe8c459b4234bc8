"""Reed-Solomon k+m erasure encode: the Hopper kernel (``csrc/rs.cu``),
K5, and its plain PyTorch version.

Replaces ``rs_encode_pallas`` (``src/repro/kernels/ckpt_codec/
rs_kernel.py:87``).  Parity ``P = C @ D`` over GF(2^8) (polynomial 0x11D)
with the generator of :func:`.rs.rs_generator_matrix`, mapping ``(k,
stride)`` uint8 data rows to ``(m, stride)`` uint8 parity, ``m <= 2``.

* ``rs_encode_ref``: the plain version, the twin of the reference's
  ``rs_encode_ref`` (``rs_kernel.py:32-73``): xtime and XOR on integer
  tensors, the products unrolled over the coefficients' bits.
* ``rs_encode_cuda``: the kernel, compiled with ``nvcc`` for ``sm_90a`` at
  first use (``kernels/common.load_library``) and called through its plain
  C interface with ``ctypes`` on PyTorch's current stream.

Both equal ``rs.rs_encode_np`` bit for bit.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from ..common import load_library
from .rs import rs_generator_matrix

SOURCES = (Path(__file__).resolve().parent / "csrc" / "rs.cu",)
MAX_K, MAX_M = 256, 2

# launches in this process; a run sets it to 0 and reads it to show that a
# path went through the kernel
launches = 0


def _xtime(x: torch.Tensor) -> torch.Tensor:
    """GF(2^8) multiply-by-x on int32 lanes holding byte values."""
    return (x << 1) ^ ((x >> 7) * 0x11D)


def _gf_mul_const(x: torch.Tensor, coef: int) -> torch.Tensor:
    """Byte lanes times the constant ``coef``: at most 8 xtimes and XORs."""
    coef = int(coef)
    acc = torch.zeros_like(x)
    cur = x
    while coef:
        if coef & 1:
            acc = acc ^ cur
        coef >>= 1
        if coef:
            cur = _xtime(cur)
    return acc


def rs_encode_ref(data_rows: torch.Tensor, m: int) -> torch.Tensor:
    """(k, stride) uint8 -> (m, stride) uint8 parity, in int32 lanes."""
    k = data_rows.shape[0]
    coef = rs_generator_matrix(k, m)
    d = data_rows.to(torch.int32)
    rows = []
    for j in range(m):
        acc = torch.zeros_like(d[0])
        for i in range(k):
            acc = acc ^ _gf_mul_const(d[i], coef[j][i])
        rows.append(acc)
    return torch.stack(rows).to(torch.uint8)


def _lib() -> ctypes.CDLL:
    lib = load_library("rs", SOURCES)
    fn = lib.rs_encode
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, ci, ci, ctypes.c_longlong, vp, vp]
        fn.restype = ci
        lib.rs_error_string.argtypes = [ci]
        lib.rs_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel's library."""
    _lib()


def rs_encode_cuda(data_rows: torch.Tensor, m: int) -> torch.Tensor:
    """data_rows: (k, stride) uint8, contiguous, on a CUDA device, 1 <= k
    <= 256; 1 <= m <= 2.  Returns the (m, stride) uint8 parity."""
    global launches
    if data_rows.device.type != "cuda":
        raise ValueError(f"data is on {data_rows.device}, the kernel needs "
                         f"CUDA")
    if data_rows.dtype != torch.uint8 or data_rows.dim() != 2:
        raise ValueError(f"data must be 2-d uint8, got {data_rows.dtype} "
                         f"{tuple(data_rows.shape)}")
    if not data_rows.is_contiguous():
        raise ValueError("data is not contiguous")
    k, stride = data_rows.shape
    if not (1 <= k <= MAX_K and 1 <= m <= MAX_M):
        raise ValueError(f"k={k}, m={m}: the kernel takes 1 <= k <= {MAX_K}, "
                         f"1 <= m <= {MAX_M}")
    parity = torch.empty((m, stride), dtype=torch.uint8,
                         device=data_rows.device)
    if stride == 0:
        return parity
    coef = np.ascontiguousarray(rs_generator_matrix(k, m), dtype=np.uint8)
    lib = _lib()
    stream = torch.cuda.current_stream(data_rows.device).cuda_stream
    status = lib.rs_encode(data_rows.data_ptr(), parity.data_ptr(), k, m,
                           stride, coef.ctypes.data, stream)
    if status != 0:
        msg = lib.rs_error_string(status).decode()
        raise RuntimeError(f"rs_encode launch failed: {msg} ({status})")
    launches += 1
    return parity
