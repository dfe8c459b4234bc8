"""Wrappers of the Hopper RG-LRU scan kernels, K7:

* ``rglru_sm90_cuda``: the scan with its loads by TMA through an mbarrier
  ring (``csrc/rglru_sm90.cu``, over the helpers of
  ``flash_attention/csrc/sm90.cuh``), laid out by ``plan``;
* ``rglru_cuda``: the scan with its loads in registers
  (``csrc/rglru.cu``).

Both take the same f32 steps, so they agree bit for bit; ``ops.rglru``
routes between them by length.  Both replace ``rglru_pallas``
(``src/repro/kernels/rglru/kernel.py:58``).  Their backward, the reverse
scan, replaces the reference's ``ops._rglru_bwd`` (``ops.py:54-86``) in
two kernels of the same two designs, bit-equal to each other:

* ``rglru_bwd_sm90_cuda``: log_a, dh and h (one token earlier) by TMA
  through an mbarrier ring, walked from the last chunk to the first
  (``csrc/rglru_bwd_sm90.cu``), laid out by ``plan`` too;
* ``rglru_bwd_cuda``: the loads in registers (``csrc/rglru_bwd.cu``).

Each CUDA source is compiled
with ``nvcc`` for ``sm_90a`` at first use (``kernels/common.load_library``)
and called through its plain C interface with ``ctypes`` on PyTorch's
current stream.  Every launch records its work (``cost``) with
``common.record_cost``; ``rglru_meta`` and ``rglru_bwd_meta`` do the same
for ``meta`` tensors, launching nothing.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from ..common import CONVERT_HEADER, check_tensor, load_library, \
    record_cost

_CSRC = Path(__file__).resolve().parent / "csrc"
# the headers of the sources that include csrc/rglru.cuh
_RGLRU_HEADERS = (_CSRC / "rglru.cuh", _CSRC.parent.parent
                  / "flash_attention" / "csrc" / "sm90.cuh", CONVERT_HEADER)
# library name -> (its source, the headers it includes)
LIBRARIES = {
    "rglru": (_CSRC / "rglru.cu", (CONVERT_HEADER,)),
    "rglru_sm90": (_CSRC / "rglru_sm90.cu", _RGLRU_HEADERS),
    "rglru_bwd": (_CSRC / "rglru_bwd.cu", _RGLRU_HEADERS),
    "rglru_bwd_sm90": (_CSRC / "rglru_bwd_sm90.cu", _RGLRU_HEADERS)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROW_MULTIPLE = {torch.float32: 4, torch.bfloat16: 8}

# launches of the register kernel, of the TMA one and of their backwards
# (``bwd_launches`` the register backward's, ``bwd_sm90_launches`` the TMA
# one's) in this process; a run sets them to 0 and reads them to show that
# a path went through them
launches = 0
sm90_launches = 0
bwd_launches = 0
bwd_sm90_launches = 0

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"rglru": [_VP] * 5 + [_CI] * 4 + [_VP],
             "rglru_sm90": [_VP] * 5 + [_CI] * 6 + [_VP],
             "rglru_bwd": [_VP] * 8 + [_CI] * 4 + [_VP],
             "rglru_bwd_sm90": [_VP] * 8 + [_CI] * 6 + [_VP]}

# the TMA kernels' geometry (``csrc/rglru_sm90.cu`` and
# ``csrc/rglru_bwd_sm90.cu``): a CTA of a chain warp and four helper warps
# on a strip of STRIP channels of one batch row, walking its tokens in
# chunks of 32 or 128 (each kernel's two instances) through a ring of
# stages; the kernels check their boxes and shared memory themselves
STRIP = 32
CHUNKS = (32, 128)
# three stages, two chunks in flight while the third is worked on: deeper
# rings measured no faster (PERF.md, K7's ring-depth sweep)
STAGES = 3
H100_SMS = 132


def row_multiple(dtype: torch.dtype) -> int:
    """The channel counts D the TMA kernel takes are multiples of this:
    rows of log_a (f32) and g must be a multiple of 16 bytes (0 for a
    dtype the kernels do not take)."""
    return _ROW_MULTIPLE.get(dtype, 0)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan(b: int, t: int, d: int, sms: int = H100_SMS) -> Tuple[int, int]:
    """``(tokens, stages)`` of the ``rglru_sm90`` and ``rglru_bwd_sm90``
    launches for (B, T, D) on a card of ``sms`` SMs (the same grid, so the
    same choice): chunks of 128 tokens when each of the grid's
    ceil(D / STRIP) x B CTAs has an SM to itself (one batch row: the chain
    warp steps more tokens a wait), of 32 when CTAs share SMs (more,
    smaller loads at once); a ring of STAGES stages, or of as many as
    there are chunks."""
    if min(b, t, d) <= 0:
        raise ValueError(f"no plan for B {b}, T {t}, D {d}")
    tokens = CHUNKS[-(-d // STRIP) * b <= sms]
    return tokens, min(STAGES, -(-t // tokens))


def _lib(name: str):
    """The loaded library ``name`` and its C entry."""
    source, headers = LIBRARIES[name]
    lib = load_library(name, (source,), headers)
    fn = getattr(lib, "rglru_fwd" if name == "rglru" else name)
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


def _check(log_a, g, h0) -> Tuple[int, int, int]:
    if g.dim() != 3:
        raise ValueError(f"g must be (B, T, D), got {tuple(g.shape)}")
    b, t, d = g.shape
    check_tensor("g", g, (b, t, d), tuple(_DTYPES), g.device)
    check_tensor("log_a", log_a, (b, t, d), (torch.float32,), g.device)
    if h0 is not None:
        check_tensor("h0", h0, (b, d), (torch.float32,), g.device)
    return b, t, d


def _check_tma(d: int, what: str, dtype: torch.dtype, **tensors) -> None:
    """Raise ValueError unless ``tensors`` (which TMA reads) are 16-byte
    aligned and D is a multiple of ``row_multiple(dtype)`` (rows of a
    multiple of 16 bytes); ``what`` names the tensor of ``dtype``."""
    for name, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned (TMA)")
    m = row_multiple(dtype)
    if d % m:
        raise ValueError(f"D = {d}: TMA needs rows of a multiple of 16 "
                         f"bytes (D a multiple of {m} for {dtype} {what})")


def _empty(g, h0):
    """The outputs of a call with no token or no channel."""
    b, _, d = g.shape
    return torch.empty_like(g), (
        torch.zeros((b, d), dtype=torch.float32, device=g.device)
        if h0 is None else h0.clone())


def cost(name: str, b: int, t: int, d: int,
         itemsize: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one call of kernel ``name`` at (B, T, D) with g
    (forward) or h and dh (backward) of ``itemsize`` bytes, as its bound
    in ``PERF.md`` counts them.  Forward: log_a (f32), g and h a token,
    h0 and h_final (f32) a channel; an exp and a multiply-add an element.
    Backward: log_a and dlog_a (f32), h, dh and dg a token, h0, dh_last
    and dh0 (f32) a channel; an exp and three multiplies an element."""
    if name in ("rglru", "rglru_sm90"):
        return 3 * b * t * d, b * t * d * (4 + 2 * itemsize) + 2 * b * d * 4
    return 4 * b * t * d, b * t * d * (8 + 3 * itemsize) + 3 * b * d * 4


def rglru_meta(name: str, log_a: torch.Tensor, g: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel ``name`` ("rglru" or "rglru_sm90") on ``meta`` tensors: the
    launch's outputs, and its work recorded."""
    b, t, d = g.shape
    if t == 0 or b * d == 0:
        return _empty(g, h0)
    h = torch.empty_like(g)
    h_final = torch.empty((b, d), dtype=torch.float32, device=g.device)
    record_cost(name, *cost(name, b, t, d, g.element_size()))
    return h, h_final


def rglru_bwd_meta(name: str, log_a: torch.Tensor, h: torch.Tensor,
                   h0: Optional[torch.Tensor], dh: torch.Tensor,
                   dh_last: Optional[torch.Tensor] = None):
    """Backward kernel ``name`` ("rglru_bwd" or "rglru_bwd_sm90") on
    ``meta`` tensors: the launch's outputs, and its work recorded."""
    b, t, d = h.shape
    if t == 0 or b * d == 0:
        return _empty_bwd(log_a, h, h0, dh_last)
    out = (torch.empty_like(log_a), torch.empty_like(h),
           None if h0 is None else torch.empty_like(h0))
    record_cost(name, *cost(name, b, t, d, h.element_size()))
    return out


def rglru_cuda(log_a: torch.Tensor, g: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The register kernel.  log_a: (B, T, D) f32, g: (B, T, D) f32 or
    bf16, h0: (B, D) f32 or None (zeros), all contiguous on one CUDA
    device.  Returns ``(h in g.dtype, h_final f32)``."""
    global launches
    b, t, d = _check(log_a, g, h0)
    if t == 0 or b * d == 0:
        return _empty(g, h0)
    h = torch.empty_like(g)
    h_final = torch.empty((b, d), dtype=torch.float32, device=g.device)
    _call("rglru", log_a.data_ptr(), g.data_ptr(),
          None if h0 is None else h0.data_ptr(), h.data_ptr(),
          h_final.data_ptr(), b, t, d, _DTYPES[g.dtype],
          torch.cuda.current_stream(g.device).cuda_stream)
    launches += 1
    record_cost("rglru", *cost("rglru", b, t, d, g.element_size()))
    return h, h_final


def rglru_sm90_cuda(log_a: torch.Tensor, g: torch.Tensor,
                    h0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TMA kernel: as ``rglru_cuda``, but log_a and g 16-byte aligned
    and D a multiple of ``row_multiple(g.dtype)`` (TMA reads them), else
    ValueError."""
    global sm90_launches
    b, t, d = _check(log_a, g, h0)
    if t == 0 or b * d == 0:
        return _empty(g, h0)
    _check_tma(d, "g", g.dtype, log_a=log_a, g=g)
    tokens, stages = plan(b, t, d, _sms(g.device.index))
    h = torch.empty_like(g)      # 16-byte aligned: the kernel's stores
    h_final = torch.empty((b, d), dtype=torch.float32, device=g.device)
    _call("rglru_sm90", log_a.data_ptr(), g.data_ptr(),
          None if h0 is None else h0.data_ptr(), h.data_ptr(),
          h_final.data_ptr(), b, t, d, _DTYPES[g.dtype], tokens, stages,
          torch.cuda.current_stream(g.device).cuda_stream)
    sm90_launches += 1
    record_cost("rglru_sm90", *cost("rglru_sm90", b, t, d, g.element_size()))
    return h, h_final


def _check_bwd(log_a, h, h0, dh, dh_last) -> Tuple[int, int, int]:
    b, t, d = _check(log_a, h, h0)
    check_tensor("dh", dh, (b, t, d), (h.dtype,), h.device)
    if dh_last is not None:
        check_tensor("dh_last", dh_last, (b, d), (torch.float32,), h.device)
    return b, t, d


def _empty_bwd(log_a, h, h0, dh_last):
    """The gradients of a call with no token or no channel."""
    return torch.zeros_like(log_a), torch.zeros_like(h), \
        None if h0 is None else (torch.zeros_like(h0) if dh_last is None
                                 else dh_last.clone())


def _bwd(name, log_a, h, h0, dh, dh_last, *layout):
    """Launch backward library ``name`` (``layout``: the TMA kernel's
    chunk and ring depth) on checked inputs; returns its outputs."""
    b, t, d = h.shape
    dlog_a = torch.empty_like(log_a)   # 16-byte aligned: the TMA kernel's
    dg = torch.empty_like(h)           # stores
    dh0 = None if h0 is None else torch.empty_like(h0)
    _call(name, log_a.data_ptr(), h.data_ptr(),
          None if h0 is None else h0.data_ptr(), dh.data_ptr(),
          None if dh_last is None else dh_last.data_ptr(), dlog_a.data_ptr(),
          dg.data_ptr(), None if dh0 is None else dh0.data_ptr(), b, t, d,
          _DTYPES[h.dtype], *layout,
          torch.cuda.current_stream(h.device).cuda_stream)
    return dlog_a, dg, dh0


def rglru_bwd_cuda(log_a: torch.Tensor, h: torch.Tensor,
                   h0: Optional[torch.Tensor], dh: torch.Tensor,
                   dh_last: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor,
                              Optional[torch.Tensor]]:
    """The register backward kernel: the gradients of ``(h, h_final)``
    from their cotangents.  log_a: (B, T, D) f32; h (the forward's output)
    and dh: (B, T, D) of one dtype, f32 or bf16; h0, dh_last: (B, D) f32 or
    None (zeros); all contiguous on one CUDA device.  Returns ``(dlog_a
    f32, dg in h.dtype, dh0 f32, or None when h0 is None)``;
    deterministic."""
    global bwd_launches
    b, t, d = _check_bwd(log_a, h, h0, dh, dh_last)
    if t == 0 or b * d == 0:
        return _empty_bwd(log_a, h, h0, dh_last)
    out = _bwd("rglru_bwd", log_a, h, h0, dh, dh_last)
    bwd_launches += 1
    record_cost("rglru_bwd", *cost("rglru_bwd", b, t, d, h.element_size()))
    return out


def rglru_bwd_sm90_cuda(log_a: torch.Tensor, h: torch.Tensor,
                        h0: Optional[torch.Tensor], dh: torch.Tensor,
                        dh_last: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   Optional[torch.Tensor]]:
    """The TMA backward kernel: as ``rglru_bwd_cuda``, and bit-equal to it,
    but log_a, h and dh 16-byte aligned and D a multiple of
    ``row_multiple(h.dtype)`` (TMA reads them), else ValueError."""
    global bwd_sm90_launches
    b, t, d = _check_bwd(log_a, h, h0, dh, dh_last)
    if t == 0 or b * d == 0:
        return _empty_bwd(log_a, h, h0, dh_last)
    _check_tma(d, "h", h.dtype, log_a=log_a, h=h, dh=dh)
    out = _bwd("rglru_bwd_sm90", log_a, h, h0, dh, dh_last,
               *plan(b, t, d, _sms(h.device.index)))
    bwd_sm90_launches += 1
    record_cost("rglru_bwd_sm90",
                *cost("rglru_bwd_sm90", b, t, d, h.element_size()))
    return out
