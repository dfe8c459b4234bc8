"""Wrappers of the Hopper RWKV-6 recurrence kernels, K6:

* ``rwkv6_sm90_cuda``: the chunked form on the tensor cores for bf16
  r/k/v (``csrc/rwkv6_sm90.cu``: mma.sync with split-bf16 operands, fed
  by TMA through the helpers of ``flash_attention/csrc/sm90.cuh``);
* ``rwkv6_cuda``: the sequential recurrence on CUDA cores for f32 or bf16
  (``csrc/rwkv6.cu``).

``ops.rwkv6`` routes between them.  Both replace ``rwkv6_pallas``
(``src/repro/kernels/rwkv6/kernel.py:86``).  Their backward, which
replaces the reference's ``ops._rwkv6_bwd`` (``ops.py:90-96``), the vjp
of its chunked form, has the same two designs, which ``ops`` routes by the
same rule:

* ``rwkv6_bwd_sm90_cuda``: the chunked form on the tensor cores for bf16
  (``csrc/rwkv6_bwd_sm90.cu``: three passes over chunks, mma.sync with
  split-bf16 operands);
* ``rwkv6_bwd_cuda``: the sequential backward on CUDA cores for f32 or
  bf16 (``csrc/rwkv6_bwd.cu``).

Each CUDA source is compiled with ``nvcc`` for ``sm_90a`` at first use
(``kernels/common.load_library``) and called through its plain C
interface with ``ctypes`` on PyTorch's current stream.  Every launch
records its work (``cost``) with ``common.record_cost``; ``rwkv6_meta``
and ``rwkv6_bwd_meta`` do the same for ``meta`` tensors, launching
nothing.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from ..common import CONVERT_HEADER, check_tensor, load_library, \
    record_cost

_CSRC = Path(__file__).resolve().parent / "csrc"
_SM90 = (_CSRC.parent.parent / "flash_attention" / "csrc" / "sm90.cuh",
         _CSRC / "chunk.cuh")
# library name -> (its source, the headers it includes)
LIBRARIES = {
    "rwkv6": (_CSRC / "rwkv6.cu", (CONVERT_HEADER,)),
    "rwkv6_sm90": (_CSRC / "rwkv6_sm90.cu", _SM90),
    "rwkv6_bwd": (_CSRC / "rwkv6_bwd.cu", (CONVERT_HEADER,)),
    "rwkv6_bwd_sm90": (_CSRC / "rwkv6_bwd_sm90.cu", _SM90)}
HEAD_DIMS = (16, 32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the sequential and of the chunked kernel, and of their
# backwards, in this process; a run sets them to 0 and reads them to show
# that a path went through them
launches = 0
sm90_launches = 0
bwd_launches = 0
bwd_sm90_launches = 0
# both backwards keep the state before every BWD_CHUNK tokens
BWD_CHUNK = 64
# the chunked forward's chunk
FWD_CHUNK = 64

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"rwkv6": [_VP] * 8 + [_CI] * 5 + [_VP],
             "rwkv6_sm90": [_VP] * 8 + [_CI] * 4 + [_VP],
             "rwkv6_bwd": [_VP] * 17 + [_CI] * 5 + [_VP],
             "rwkv6_bwd_sm90": [_VP] * 18 + [_CI] * 4 + [_VP]}


def _lib(name: str):
    """The loaded library ``name`` and its C entry."""
    source, headers = LIBRARIES[name]
    lib = load_library(name, (source,), headers)
    fn = getattr(lib, "rwkv6_fwd" if name == "rwkv6" else name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
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


def _check(r, k, v, log_w, u, s0, dtypes) -> Tuple[int, int, int, int]:
    if r.dim() != 4:
        raise ValueError(f"r must be (B, H, T, D), got {tuple(r.shape)}")
    b, h, t, d = r.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if r.dtype not in dtypes:
        raise ValueError(f"dtype {r.dtype} not supported: "
                         f"{sorted(map(str, dtypes))}")
    for name, x in (("r", r), ("k", k), ("v", v)):
        check_tensor(name, x, (b, h, t, d), (r.dtype,), r.device)
    check_tensor("log_w", log_w, (b, h, t, d), (torch.float32,), r.device)
    check_tensor("u", u, (h, d), (torch.float32,), r.device)
    if s0 is not None:
        check_tensor("s0", s0, (b, h, d, d), (torch.float32,), r.device)
    return b, h, t, d


def cost(name: str, b: int, h: int, t: int, d: int,
         itemsize: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one call of kernel ``name`` at (B, H, T, D) with
    r/k/v of ``itemsize`` bytes, as its bound in ``PERF.md`` counts them.
    Bytes: each input read once, each output written once (r, k, v, o and
    f32 log_w a token; u; s0 and sT; the backward adds do, dr, dk, dv,
    dlog_w, du and ds0).  FLOPs: the chunked forward's four products a
    chunk, 2 C D^2 each; the sequential forward's 5 operations a state
    element a token; the chunked backward's five C D^2 products and five
    lower-triangle C^2 D ones a chunk; the sequential backward's six D x D
    products a token."""
    n = b * h * t * d
    if name in ("rwkv6", "rwkv6_sm90"):
        nbytes = n * (4 * itemsize + 4) + h * d * 4 + 2 * b * h * d * d * 4
        flops = (8 * FWD_CHUNK * d * d * -(-t // FWD_CHUNK) * b * h
                 if name == "rwkv6_sm90" else 5 * b * h * t * d * d)
    else:
        nbytes = n * (7 * itemsize + 8) + 2 * h * d * 4 \
            + 3 * b * h * d * d * 4
        flops = (b * h * -(-t // BWD_CHUNK)
                 * (12 * BWD_CHUNK * d * d + 5 * BWD_CHUNK ** 2 * d)
                 if name == "rwkv6_bwd_sm90" else 12 * b * h * t * d * d)
    return flops, nbytes


def rwkv6_meta(name: str, r: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, log_w: torch.Tensor, u: torch.Tensor,
               s0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel ``name`` ("rwkv6" or "rwkv6_sm90") on ``meta`` tensors: the
    launch's outputs, and its work recorded."""
    b, h, t, d = r.shape
    o = torch.empty_like(v)
    if t == 0 or b * h == 0:
        return o, s0.clone()
    sT = torch.empty_like(s0)
    record_cost(name, *cost(name, b, h, t, d, r.element_size()),
                reads=(r, k, v, log_w, u, s0))
    return o, sT


def rwkv6_bwd_meta(name: str, r, k, v, log_w, u, s0, do, dsT=None):
    """Backward kernel ``name`` ("rwkv6_bwd" or "rwkv6_bwd_sm90") on
    ``meta`` tensors: the launch's outputs and scratch, and its work
    recorded."""
    b, h, t, d = r.shape
    dr, dk, dv = (torch.empty_like(x) for x in (r, k, v))
    dlog_w = torch.empty_like(log_w)
    du = torch.empty_like(u)
    ds0 = None if s0 is None else torch.empty_like(s0)
    if t == 0 or b * h == 0:
        for x in (dr, dk, dv, dlog_w, du):
            x.zero_()
        if ds0 is not None:
            ds0.zero_() if dsT is None else ds0.copy_(dsT)
        return dr, dk, dv, dlog_w, du, ds0
    nc = -(-t // BWD_CHUNK)
    f32 = dict(dtype=torch.float32, device=r.device)
    if name == "rwkv6_bwd_sm90":
        scratch = (torch.empty((b, h, nc, d), **f32),
                   torch.empty((b, h, nc + 1, d, d), **f32),
                   torch.empty((b, h, nc, d, d), **f32),
                   torch.empty((b, h, nc, d), **f32))
    else:
        scratch = (torch.empty((b, h, nc, d, d), **f32),
                   torch.empty((b, h, BWD_CHUNK, d, d), **f32),
                   torch.empty((b, h, d), **f32))
    del scratch
    record_cost(name, *cost(name, b, h, t, d, r.element_size()),
                reads=(r, k, v, log_w, u, s0, do, dsT))
    return dr, dk, dv, dlog_w, du, ds0


def rwkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential kernel.  r/k/v: (B, H, T, D) of one dtype (f32 or
    bf16), log_w: (B, H, T, D) f32, u: (H, D) f32, s0: (B, H, D, D) f32,
    all contiguous on one CUDA device, D in {16, 32, 64}.  Returns ``(o in
    v.dtype, sT f32)``."""
    global launches
    b, h, t, d = _check(r, k, v, log_w, u, s0, _DTYPES)
    o = torch.empty_like(v)
    if t == 0 or b * h == 0:
        return o, s0.clone()
    sT = torch.empty_like(s0)
    _call("rwkv6", r.data_ptr(), k.data_ptr(), v.data_ptr(),
          log_w.data_ptr(), u.data_ptr(), s0.data_ptr(), o.data_ptr(),
          sT.data_ptr(), b, h, t, d, _DTYPES[r.dtype],
          torch.cuda.current_stream(r.device).cuda_stream)
    launches += 1
    record_cost("rwkv6",
                *cost("rwkv6", b, h, t, d, r.element_size()),
                reads=(r, k, v, log_w, u, s0))
    return o, sT


def rwkv6_sm90_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked tensor-core kernel: as ``rwkv6_cuda`` but r/k/v bf16
    only, and r/k/v/log_w 16-byte aligned (TMA reads them)."""
    global sm90_launches
    b, h, t, d = _check(r, k, v, log_w, u, s0, (torch.bfloat16,))
    for name, x in (("r", r), ("k", k), ("v", v), ("log_w", log_w)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned (TMA)")
    o = torch.empty_like(v)
    if t == 0 or b * h == 0:
        return o, s0.clone()
    sT = torch.empty_like(s0)
    _call("rwkv6_sm90", r.data_ptr(), k.data_ptr(), v.data_ptr(),
          log_w.data_ptr(), u.data_ptr(), s0.data_ptr(), o.data_ptr(),
          sT.data_ptr(), b, h, t, d,
          torch.cuda.current_stream(r.device).cuda_stream)
    sm90_launches += 1
    record_cost("rwkv6_sm90",
                *cost("rwkv6_sm90", b, h, t, d, r.element_size()),
                reads=(r, k, v, log_w, u, s0))
    return o, sT


def rwkv6_bwd_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   log_w: torch.Tensor, u: torch.Tensor,
                   s0: Optional[torch.Tensor], do: torch.Tensor,
                   dsT: Optional[torch.Tensor] = None):
    """The backward kernel: the gradients of ``(o, sT)`` from their
    cotangents, with log_w as given (not clamped: the reference's
    backward).  r/k/v/do: (B, H, T, D) of one dtype (f32 or bf16), log_w:
    (B, H, T, D) f32, u: (H, D) f32, s0 and dsT: (B, H, D, D) f32 or None
    (zeros), all contiguous on one CUDA device, D in {16, 32, 64}.
    Returns ``(dr, dk, dv in r.dtype, dlog_w f32, du f32, ds0 f32 or None
    when s0 is None)``; deterministic (du sums over B in order, no
    atomics)."""
    global bwd_launches
    b, h, t, d = _check(r, k, v, log_w, u, s0, _DTYPES)
    check_tensor("do", do, (b, h, t, d), (r.dtype,), r.device)
    if dsT is not None:
        check_tensor("dsT", dsT, (b, h, d, d), (torch.float32,), r.device)
    dr, dk, dv = (torch.empty_like(x) for x in (r, k, v))
    dlog_w = torch.empty_like(log_w)
    du = torch.empty_like(u)
    ds0 = None if s0 is None else torch.empty_like(s0)
    if t == 0 or b * h == 0:
        for x in (dr, dk, dv, dlog_w, du):
            x.zero_()
        if ds0 is not None:
            ds0.zero_() if dsT is None else ds0.copy_(dsT)
        return dr, dk, dv, dlog_w, du, ds0
    nc = -(-t // BWD_CHUNK)
    # scratch: the state before each chunk, the window of a chunk's states,
    # and each (b, h)'s part of du
    bound = torch.empty((b, h, nc, d, d), dtype=torch.float32,
                        device=r.device)
    win = torch.empty((b, h, BWD_CHUNK, d, d), dtype=torch.float32,
                      device=r.device)
    du_part = torch.empty((b, h, d), dtype=torch.float32, device=r.device)
    _call("rwkv6_bwd", r.data_ptr(), k.data_ptr(), v.data_ptr(),
          log_w.data_ptr(), u.data_ptr(),
          None if s0 is None else s0.data_ptr(), do.data_ptr(),
          None if dsT is None else dsT.data_ptr(), dr.data_ptr(),
          dk.data_ptr(), dv.data_ptr(), dlog_w.data_ptr(),
          du_part.data_ptr(), du.data_ptr(),
          None if ds0 is None else ds0.data_ptr(), bound.data_ptr(),
          win.data_ptr(), b, h, t, d, _DTYPES[r.dtype],
          torch.cuda.current_stream(r.device).cuda_stream)
    bwd_launches += 1
    record_cost("rwkv6_bwd",
                *cost("rwkv6_bwd", b, h, t, d, r.element_size()),
                reads=(r, k, v, log_w, u, s0, do, dsT))
    return dr, dk, dv, dlog_w, du, ds0


def rwkv6_bwd_sm90_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        log_w: torch.Tensor, u: torch.Tensor,
                        s0: Optional[torch.Tensor], do: torch.Tensor,
                        dsT: Optional[torch.Tensor] = None):
    """The chunked tensor-core backward: as ``rwkv6_bwd_cuda`` but r/k/v/do
    bf16 only and 16-byte aligned (read 16 bytes at a time); deterministic
    (du sums over B and chunks in order, no atomics)."""
    global bwd_sm90_launches
    b, h, t, d = _check(r, k, v, log_w, u, s0, (torch.bfloat16,))
    check_tensor("do", do, (b, h, t, d), (r.dtype,), r.device)
    for name, x in (("r", r), ("k", k), ("v", v), ("do", do)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if dsT is not None:
        check_tensor("dsT", dsT, (b, h, d, d), (torch.float32,), r.device)
    dr, dk, dv = (torch.empty_like(x) for x in (r, k, v))
    dlog_w = torch.empty_like(log_w)
    du = torch.empty_like(u)
    ds0 = None if s0 is None else torch.empty_like(s0)
    if t == 0 or b * h == 0:
        for x in (dr, dk, dv, dlog_w, du):
            x.zero_()
        if ds0 is not None:
            ds0.zero_() if dsT is None else ds0.copy_(dsT)
        return dr, dk, dv, dlog_w, du, ds0
    nc = -(-t // BWD_CHUNK)
    # scratch: each chunk's decay; its state update, then (in place) the
    # state before it and after the last; its cotangent update, then the
    # cotangent after it; its part of du
    f32 = dict(dtype=torch.float32, device=r.device)
    decay = torch.empty((b, h, nc, d), **f32)
    states = torch.empty((b, h, nc + 1, d, d), **f32)
    cotangents = torch.empty((b, h, nc, d, d), **f32)
    du_part = torch.empty((b, h, nc, d), **f32)
    _call("rwkv6_bwd_sm90", r.data_ptr(), k.data_ptr(), v.data_ptr(),
          log_w.data_ptr(), u.data_ptr(),
          None if s0 is None else s0.data_ptr(), do.data_ptr(),
          None if dsT is None else dsT.data_ptr(), dr.data_ptr(),
          dk.data_ptr(), dv.data_ptr(), dlog_w.data_ptr(), du.data_ptr(),
          None if ds0 is None else ds0.data_ptr(), decay.data_ptr(),
          states.data_ptr(), cotangents.data_ptr(), du_part.data_ptr(), b, h,
          t, d, torch.cuda.current_stream(r.device).cuda_stream)
    bwd_sm90_launches += 1
    record_cost("rwkv6_bwd_sm90",
                *cost("rwkv6_bwd_sm90", b, h, t, d, r.element_size()),
                reads=(r, k, v, log_w, u, s0, do, dsT))
    return dr, dk, dv, dlog_w, du, ds0
