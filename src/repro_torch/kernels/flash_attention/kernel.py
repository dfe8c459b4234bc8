"""Wrappers of the Hopper flash-attention kernels, routed by dtype:

* bf16: the tensor-core kernels, wgmma fed by TMA (``csrc/flash_fwd_sm90.cu``
  and ``csrc/flash_bwd_sm90.cu``, over ``csrc/sm90.cuh``), at every head
  dim, 256 (recurrentgemma-9b's attention layers) included;
* f32: the f32-FMA kernels (``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``),
  which TF32 tensor cores could not replace within f32's tolerances.

Replace ``flash_attention_pallas`` (``src/repro/kernels/flash_attention/
kernel.py:95``) and its XLA backward (``ops._xla_flash_bwd``, ``ops.py:94``).
Each CUDA source is compiled with ``nvcc`` for ``sm_90a`` at first use
(``kernels/common.load_library``) and called through its plain C interface
with ``ctypes`` on PyTorch's current stream.

Every launch records its work (``fwd_cost`` / ``bwd_cost``) with
``common.record_cost``; ``flash_attention_meta`` and
``flash_attention_bwd_meta`` give ``meta`` tensors the outputs and scratch
of a launch and record the same work, launching nothing.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..common import load_library, record_cost

_CSRC = Path(__file__).resolve().parent / "csrc"
# library name -> its source, and the headers a library includes
LIBRARIES = {"flash_fwd": _CSRC / "flash_fwd.cu",
             "flash_bwd": _CSRC / "flash_bwd.cu",
             "flash_fwd_sm90": _CSRC / "flash_fwd_sm90.cu",
             "flash_bwd_sm90": _CSRC / "flash_bwd_sm90.cu"}
HEADERS = {"flash_fwd_sm90": (_CSRC / "sm90.cuh",),
           "flash_bwd_sm90": (_CSRC / "sm90.cuh",)}
# head dims each kernel is instantiated for, 160 for pixtral-12b's and 256
# for recurrentgemma-9b's attention layers
FWD_HEAD_DIMS = (32, 64, 128, 160, 256)
BWD_HEAD_DIMS = FWD_HEAD_DIMS
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the forward and of the backward in this process, and of the
# backward the bf16 (wgmma) library among them; a run sets them to 0 and
# reads them to show that a path went through the kernels
launches = 0
bwd_launches = 0
bwd_sm90_launches = 0


_VP, _CI = ctypes.c_void_p, ctypes.c_int
# the C entry's arguments: the forward's and the backward's, one interface
# for both dtypes' libraries
_ARGTYPES = {
    "fwd": [_VP] * 5 + [_CI] * 6 + [ctypes.c_float] + [_CI] * 4 + [_VP],
    "bwd": [_VP] * 11 + [_CI] * 6 + [ctypes.c_float] + [_CI] * 5 + [_VP]}


def _lib(name: str):
    """The loaded library ``name`` and its C entry (of the same name)."""
    lib = load_library(name, (LIBRARIES[name],), HEADERS.get(name, ()))
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES["bwd" if "bwd" in name else "fwd"]
        fn.restype = _CI
        err = getattr(lib, name + "_error_string")
        err.argtypes = [_CI]
        err.restype = ctypes.c_char_p
    return lib, fn


def _call(name: str, *args) -> None:
    lib, fn = _lib(name)
    status = fn(*args)
    if status != 0:
        msg = getattr(lib, name + "_error_string")(status).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({status})")


def build(name: str) -> None:
    """Compile (if needed) and load library ``name`` of ``LIBRARIES``."""
    _lib(name)


def _library(kind: str, dtype: torch.dtype) -> str:
    """The library a call of ``kind`` ("fwd" or "bwd") in ``dtype``
    launches."""
    return f"flash_{kind}_sm90" if dtype == torch.bfloat16 else f"flash_{kind}"


# keys a block of the bf16 backward's dk/dv kernel takes at head dim 256
D256_BWD_KEYS = 64


def heads_per_part(b: int, hq: int, hkv: int, s: int, d: int,
                   sms: int) -> int:
    """How many query heads of one KV head a dk/dv block of the bf16
    backward walks and sums into one part.  At head dim 256 the most (a
    divisor of the group size Hq / Hkv) that still leave at least a block
    for each of the card's ``sms`` SMs: fewer parts to write and sum
    (recurrentgemma-9b's MQA training shape, Hq 16 over one KV head, S 4096:
    4 heads, 256 blocks, 67 MB of parts instead of 268 MB).  Below 256 the
    kernels keep one part per query head."""
    if d != 256:
        return 1
    g = hq // hkv
    key_tiles = -(-s // D256_BWD_KEYS)
    return max([hg for hg in range(1, g + 1)
                if g % hg == 0 and b * (hq // hg) * key_tiles >= sms],
               default=1)


# an H100 SXM's SMs: what ``heads_per_part`` assumes on ``meta``
H100_SMS = 132


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def allowed_pairs(t: int, s: int, causal: bool,
                  window: Optional[int]) -> int:
    """The (query, key) pairs the mask allows, query row i at position
    S - T + i (``ref.allowed_mask(...).sum()`` without the T x S mask):
    the work of the products, the tiles the kernels skip left out."""
    pos = np.arange(t, dtype=np.int64) + (s - t)
    hi = np.minimum(pos, s - 1) if causal else np.full(t, s - 1)
    lo = np.maximum(pos - window + 1, 0) if window is not None \
        else np.zeros(t, dtype=np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def fwd_cost(q_shape, kv_shape, causal: bool, window: Optional[int],
             itemsize: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one forward, as its bound in ``PERF.md`` counts
    them: Q K^T and P V over the allowed pairs, 2 FLOPs a multiply-add;
    q, k, v read and out written once in the inputs' dtype, lse f32."""
    b, hq, t, d = q_shape
    hkv, s = kv_shape[1], kv_shape[2]
    flops = 4 * b * hq * d * allowed_pairs(t, s, causal, window)
    nbytes = (2 * b * hq * t * d + 2 * b * hkv * s * d) * itemsize \
        + b * hq * t * 4
    return flops, nbytes


def bwd_cost(q_shape, kv_shape, causal: bool, window: Optional[int],
             itemsize: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one backward: five products over the allowed
    pairs; q, k, v, out and their gradients, dout, and lse twice."""
    b, hq, t, d = q_shape
    hkv, s = kv_shape[1], kv_shape[2]
    flops = 10 * b * hq * d * allowed_pairs(t, s, causal, window)
    nbytes = (5 * b * hq * t * d + 4 * b * hkv * s * d) * itemsize \
        + 2 * b * hq * t * 4
    return flops, nbytes


def _check_qkv(q, k, v, head_dims, what, extra=()):
    """Device, dtype, layout and shape checks shared by both kernels;
    ``head_dims`` are the ones kernel ``what`` is built for.  Returns
    (b, hq, hkv, t, s, d)."""
    for name, t in (("q", q), ("k", k), ("v", v), *extra):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}, the kernel needs CUDA")
        if t.device != q.device:
            raise ValueError(f"{name} and q lie on different devices")
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
    if d not in head_dims:
        raise ValueError(f"{what}: head dim {d} not in {head_dims}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if q.dtype == torch.bfloat16:
        # TMA reads each head's rows from a 16-byte aligned base
        for name, x in (("q", q), ("k", k), ("v", v), *extra):
            if x.data_ptr() % 16:
                raise ValueError(f"{name}.data_ptr() is not 16-byte aligned, "
                                 f"which the bf16 (TMA) kernel needs")
    return b, hq, hkv, t, s, d


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: Optional[int],
                         scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, Hq, T, D), k/v: (B, Hkv, S, D) CUDA tensors, contiguous, of
    one dtype (f32 or bf16; bf16 16-byte aligned), D in ``FWD_HEAD_DIMS``.
    Returns ``(out in q.dtype, lse f32 (B, Hq, T))``."""
    global launches
    b, hq, hkv, t, s, d = _check_qkv(q, k, v, FWD_HEAD_DIMS, "flash_fwd")
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _call(_library("fwd", q.dtype),
          q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
          lse.data_ptr(), b, hq, hkv, t, s, d, float(scale), int(causal),
          int(window is not None), int(window or 0), _DTYPES[q.dtype], stream)
    launches += 1
    record_cost(_library("fwd", q.dtype),
                *fwd_cost(q.shape, k.shape, causal, window, q.element_size()),
                reads=(q, k, v))
    return out, lse


def flash_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: Optional[int],
                         scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_cuda`` on ``meta`` tensors: its outputs, and its
    work recorded; nothing is launched."""
    b, hq, t, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    if out.numel():
        record_cost(_library("fwd", q.dtype),
                    *fwd_cost(q.shape, k.shape, causal, window,
                              q.element_size()), reads=(q, k, v))
    return out, lse


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool, window: Optional[int],
                             scale: float
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Gradients of the forward: q/out/dout (B, Hq, T, D), k/v (B, Hkv, S,
    D) of one dtype (bf16 16-byte aligned), lse (B, Hq, T) f32, all
    contiguous CUDA tensors, D in ``BWD_HEAD_DIMS``.  Returns ``(dq, dk,
    dv)`` in the inputs' dtype; deterministic."""
    global bwd_launches, bwd_sm90_launches
    b, hq, hkv, t, s, d = _check_qkv(q, k, v, BWD_HEAD_DIMS, "flash_bwd",
                                     (("out", out), ("dout", dout)))
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} / dout "
                         f"{tuple(dout.shape)} must match q "
                         f"{tuple(q.shape)}")
    if lse.shape != (b, hq, t) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous f32 {(b, hq, t)} on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)}")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    dsum = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    # each group of query heads' part of its KV head's dk and dv, summed in
    # head order by the last kernel (no atomics)
    name = _library("bwd", q.dtype)
    hg = 1 if name == "flash_bwd" else \
        heads_per_part(b, hq, hkv, s, d, _sm_count(q.device))
    part = torch.empty((2, b, hq // hg, s, d), dtype=torch.float32,
                       device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _call(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
          dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(), part.data_ptr(),
          dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, hq, hkv, t, s, d,
          float(scale), int(causal), int(window is not None),
          int(window or 0), _DTYPES[q.dtype], hg, stream)
    bwd_launches += 1
    if name == "flash_bwd_sm90":
        bwd_sm90_launches += 1
    record_cost(name, *bwd_cost(q.shape, k.shape, causal, window,
                                q.element_size()),
                reads=(q, k, v, out, lse, dout))
    return dq, dk, dv


def flash_attention_bwd_meta(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool, window: Optional[int],
                             scale: float
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """``flash_attention_bwd_cuda`` on ``meta`` tensors: its outputs and
    scratch (at an H100's SM count), and its work recorded."""
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    name = _library("bwd", q.dtype)
    hg = 1 if name == "flash_bwd" else \
        heads_per_part(b, hq, hkv, s, d, H100_SMS)
    # the launch's scratch, alive while it runs
    scratch = (torch.empty((b, hq, t), dtype=torch.float32, device=q.device),
               torch.empty((2, b, hq // hg, s, d), dtype=torch.float32,
                           device=q.device))
    del scratch
    record_cost(name, *bwd_cost(q.shape, k.shape, causal, window,
                                q.element_size()),
                reads=(q, k, v, out, lse, dout))
    return dq, dk, dv
