"""Public RWKV-6 op: the Hopper kernels (K6) on CUDA tensors, the plain
chunked version on CPU tensors, and on ``meta`` tensors the routed
kernel's outputs and recorded work, with nothing launched (an abstract
trace, ``launch/opcount.py``).

The twin of ``repro/kernels/rwkv6/ops.py::rwkv6``.  A call whose inputs
require grad goes through an ``autograd.Function`` that saves its inputs,
as the reference's ``custom_vjp`` does (``ops.py:84-87``), and whose
backward is the reference's, the vjp of the chunked form
(``ops.py:90-96``) with log_w unclamped: a backward kernel on CUDA,
``ref.rwkv6_bwd_ref`` on the CPU.
Nothing on CUDA runs autograd over the plain version.  The forward clamps
log_w at ``LOG_W_MIN`` (as the Pallas kernel does); below it the decay is
e^-30 or less either way, and the gradient is the unclamped one, the
reference's answer.

Routing on CUDA, by dtype and length (not a setting):

* bf16 r/k/v with at least ``SM90_MIN_T`` tokens (prefill): the chunked
  tensor-core kernel, ``kernel.rwkv6_sm90_cuda``;
* f32 r/k/v (the chunked kernel takes bf16 r/k/v only), and bf16 below
  ``SM90_MIN_T`` tokens: the sequential kernel, ``kernel.rwkv6_cuda``.

The backward follows the same rule: bf16 with at least ``SM90_MIN_T``
tokens to the chunked tensor-core backward
(``kernel.rwkv6_bwd_sm90_cuda``), the rest to the sequential one
(``kernel.rwkv6_bwd_cuda``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..common import on_cuda, on_meta
from . import kernel
from .ref import rwkv6_bwd_ref, rwkv6_chunked

# the fewest tokens the chunked kernel takes; below, the sequential one.
# The chunked kernel pays for a whole 64-token chunk and the state's
# products however few tokens it gets; the sequential one a step per
# token.  Measured at rwkv6-7b's decode width (4, 64, T, 64), bf16, on an
# H100 (chip_smoke.py's ``rwkv6_route_ms``), the sequential kernel is the
# faster up to T = 16 and the chunked one from T = 32: a decode step (T =
# 1) stays sequential.
SM90_MIN_T = 32


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          log_w: torch.Tensor, u: torch.Tensor,
          s0: Optional[torch.Tensor] = None, *, chunk: int = 64):
    """RWKV-6 time-mix core. r/k/v/log_w: (B, H, T, D), log_w <= 0 (clamped
    at -30 in the forward); u: (H, D); s0: (B, H, D, D) or None (zeros).

    Returns ``(o: (B, H, T, D) in v.dtype, s_final: (B, H, D, D) f32)``,
    differentiable in every input.  ``chunk`` is the plain versions' chunk
    length; the kernels fix their own.
    """
    tensors = (r, k, v, log_w, u) + (() if s0 is None else (s0,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _RWKV6.apply(r, k, v, log_w, u, s0, chunk)
    return _forward(r, k, v, log_w, u, s0, chunk)


def _aligned(*xs):
    """The chunked kernels read their inputs 16 bytes at a time (TMA in the
    forward) from 16-byte aligned addresses: a contiguous view at another
    offset is copied to fresh (aligned) memory."""
    return tuple(x if x.data_ptr() % 16 == 0 else x.clone() for x in xs)


def _forward(r, k, v, log_w, u, s0, chunk):
    tensors = (r, k, v, log_w, u) + (() if s0 is None else (s0,))
    meta = on_meta(*tensors)
    if not meta and not on_cuda(*tensors):
        return rwkv6_chunked(r, k, v, log_w, u, s0, chunk=chunk)
    b, h, t, d = r.shape
    if s0 is None:
        s0 = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
    r, k, v, log_w = (x.contiguous() for x in (r, k, v, log_w.float()))
    if r.dtype == torch.bfloat16 and t >= SM90_MIN_T:
        r, k, v, log_w = _aligned(r, k, v, log_w)
        name, run = "rwkv6_sm90", kernel.rwkv6_sm90_cuda
    else:
        name, run = "rwkv6", kernel.rwkv6_cuda
    args = (r, k, v, log_w, u.float().contiguous(), s0.float().contiguous())
    return kernel.rwkv6_meta(name, *args) if meta else run(*args)


class _RWKV6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, log_w, u, s0, chunk):
        o, sT = _forward(r, k, v, log_w, u, s0, chunk)
        ctx.save_for_backward(r, k, v, log_w, u, s0)
        ctx.chunk = chunk
        return o, sT

    @staticmethod
    def backward(ctx, do, dsT):
        r, k, v, log_w, u, s0 = ctx.saved_tensors
        meta = on_meta(r, k, v, log_w, u)
        if meta or on_cuda(r, k, v, log_w, u):
            f32 = (None if x is None else x.float().contiguous()
                   for x in (log_w, u, s0, dsT))
            lw, uf, s0f, dsTf = f32
            r, k, v, do = (x.contiguous() for x in (r, k, v, do.to(r.dtype)))
            if r.dtype == torch.bfloat16 and r.shape[2] >= SM90_MIN_T:
                r, k, v, do = _aligned(r, k, v, do)
                name, run = "rwkv6_bwd_sm90", kernel.rwkv6_bwd_sm90_cuda
            else:
                name, run = "rwkv6_bwd", kernel.rwkv6_bwd_cuda
            args = (r, k, v, lw, uf, s0f, do, dsTf)
            grads = kernel.rwkv6_bwd_meta(name, *args) if meta \
                else run(*args)
        else:
            grads = rwkv6_bwd_ref(r, k, v, log_w, u, s0, do, dsT,
                                  chunk=ctx.chunk)
        return tuple(None if g is None or not need else g.to(x.dtype)
                     for g, need, x in zip(grads, ctx.needs_input_grad,
                                           (r, k, v, log_w, u, s0))) \
            + (None,)
