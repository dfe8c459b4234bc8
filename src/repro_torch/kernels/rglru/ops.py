"""Public RG-LRU op: the Hopper kernels (K7) on CUDA tensors, the plain
chunked version on CPU tensors, and on ``meta`` tensors the routed
kernel's outputs and recorded work, with nothing launched (an abstract
trace, ``launch/opcount.py``).

The twin of ``repro/kernels/rglru/ops.py::rglru``.  A call whose inputs
require grad goes through an ``autograd.Function`` that saves ``(log_a,
h, h0)``, as the reference's ``custom_vjp`` does (``ops.py:47-51``), and
whose backward is the analytic reverse scan of ``ops._rglru_bwd``
(``ops.py:54-86``): the backward kernel (``kernel.rglru_bwd_cuda``) on
CUDA, ``ref.rglru_bwd_ref`` on the CPU.  Nothing on CUDA runs autograd over
the plain version.

Routing on CUDA, by length and width (not a setting):

* at least ``SM90_MIN_T`` tokens (prefill), D a multiple of
  ``kernel.row_multiple(g.dtype)`` (TMA's 16-byte rows): the TMA kernel,
  ``kernel.rglru_sm90_cuda``;
* shorter calls (a decode step), and widths TMA cannot address: the
  register kernel, ``kernel.rglru_cuda``.

The two take the same f32 steps, so the route changes no bit of the
result.  The backward routes the same way (``route_bwd``): at least
``SM90_BWD_MIN_T`` tokens whose D TMA can address to the TMA backward,
``kernel.rglru_bwd_sm90_cuda``, the rest to the register one,
``kernel.rglru_bwd_cuda``; the two are bit-equal too.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..common import on_cuda, on_meta
from . import kernel
from .ref import rglru_bwd_ref, rglru_chunked

# the fewest tokens the TMA kernel takes; below, the register kernel.
# The TMA kernel waits out its ring's first loads however few tokens it
# gets, and below about 300 tokens at recurrentgemma-9b's width the
# inputs of back-to-back calls stay in the 50 MB L2, where the register
# kernel's loads are quick.  Measured at (4, T, 4096), bf16 g, on an H100
# (chip_smoke.py's ``rglru_route_ms``): the register kernel is the faster
# up to T = 256 (by about 20 %), the two are within a few per cent from
# 257 to about 300 (either leads, call by call), and the TMA kernel is
# the faster from T = 304 (by about 15 %).  A decode step (T = 1) stays
# on the register kernel; a prefill of 512 tokens goes to the TMA one.
SM90_MIN_T = 304
# the fewest tokens the TMA backward takes; below, the register backward.
# The TMA kernel waits out its ring's first loads however few tokens it
# gets; the register kernel's one round of loads is quicker for a few
# tokens.  Measured at (1, T, 4096) and (4, T, 4096), bf16 h and dh, on an
# H100 (chip_smoke.py's ``rglru_bwd_route_ms``): the register kernel is
# the faster up to T = 16 (by 23-48 %), the two are within 3-8 % from
# T = 32 (the register kernel ahead) to T = 48 (the TMA one ahead), and the
# TMA kernel is the faster from T = 64 (by 13-34 %; at a 4096-token
# training step 6.5x at one batch row, 1.9x at four).
SM90_BWD_MIN_T = 64


def rglru(log_a: torch.Tensor, g: torch.Tensor,
          h0: Optional[torch.Tensor] = None):
    """RG-LRU core: h_t = exp(log_a_t) * h_{t-1} + g_t.  log_a, g:
    (B, T, D), log_a <= 0; h0: (B, D) or None (zeros).

    Returns ``(h: (B, T, D) in g.dtype, h_final: (B, D) f32)``,
    differentiable in log_a, g and h0.
    """
    tensors = (log_a, g) + (() if h0 is None else (h0,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _RGLRU.apply(log_a, g, h0)
    return _forward(log_a, g, h0)


def _forward(log_a, g, h0):
    tensors = (log_a, g) + (() if h0 is None else (h0,))
    meta = on_meta(*tensors)
    if not meta and not on_cuda(*tensors):
        return rglru_chunked(log_a, g, h0)
    log_a, g = log_a.float().contiguous(), g.contiguous()
    h0 = None if h0 is None else h0.float().contiguous()
    name = route(g.shape[1], g.shape[2], g.dtype)
    if name == "rglru_sm90":
        log_a, g = _aligned(log_a, g)
    if meta:
        return kernel.rglru_meta(name, log_a, g, h0)
    run = kernel.rglru_sm90_cuda if name == "rglru_sm90" else \
        kernel.rglru_cuda
    return run(log_a, g, h0)


def _aligned(*tensors):
    """TMA reads from 16-byte aligned addresses: a view at another offset
    is copied to fresh (aligned) memory."""
    return tuple(x if x.data_ptr() % 16 == 0 else x.clone() for x in tensors)


class _RGLRU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_a, g, h0):
        h, h_final = _forward(log_a, g, h0)
        ctx.save_for_backward(log_a, h, h0)
        return h, h_final

    @staticmethod
    def backward(ctx, dh, dh_last):
        log_a, h, h0 = ctx.saved_tensors
        meta = on_meta(log_a, h)
        if meta or on_cuda(log_a, h):
            f32 = (None if x is None else x.float().contiguous()
                   for x in (log_a, h0, dh_last))
            la, h0f, dlf = f32
            h, dh = h.contiguous(), dh.to(h.dtype).contiguous()
            name = route_bwd(h.shape[1], h.shape[2], h.dtype)
            if name == "rglru_bwd_sm90":
                la, h, dh = _aligned(la, h, dh)
                run = kernel.rglru_bwd_sm90_cuda
            else:
                run = kernel.rglru_bwd_cuda
            args = (la, h, h0f, dh, dlf)
            dlog_a, dg, dh0 = kernel.rglru_bwd_meta(name, *args) if meta \
                else run(*args)
        else:
            dlog_a, dg, dh0 = rglru_bwd_ref(log_a, h, h0, dh, dh_last)
        need = ctx.needs_input_grad
        return (dlog_a.to(log_a.dtype) if need[0] else None,
                dg if need[1] else None,
                dh0.to(h0.dtype) if need[2] else None)


def route(t: int, d: int, dtype: torch.dtype) -> str:
    """The kernel a CUDA call of T tokens and D channels with g of
    ``dtype`` launches: "rglru_sm90" or "rglru"."""
    return "rglru_sm90" if _tma(t, d, dtype, SM90_MIN_T) else "rglru"


def route_bwd(t: int, d: int, dtype: torch.dtype) -> str:
    """The backward kernel a CUDA call of T tokens and D channels with h of
    ``dtype`` launches: "rglru_bwd_sm90" or "rglru_bwd"."""
    return "rglru_bwd_sm90" if _tma(t, d, dtype, SM90_BWD_MIN_T) \
        else "rglru_bwd"


def _tma(t: int, d: int, dtype: torch.dtype, min_t: int) -> bool:
    """At least ``min_t`` tokens, and rows TMA can address."""
    m = kernel.row_multiple(dtype)
    return t >= min_t and m > 0 and d % m == 0
