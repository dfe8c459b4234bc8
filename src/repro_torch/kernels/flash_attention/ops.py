"""Public attention op: the Hopper kernels on CUDA tensors, the plain
versions on CPU tensors, forward and backward; on ``meta`` tensors the
kernels' outputs and recorded work, with nothing launched (an abstract
trace, ``launch/opcount.py``).

An ``autograd.Function`` saves ``(q, k, v, out, lse)`` as the reference's
``custom_vjp`` does (``repro/kernels/flash_attention/ops.py:153-190``), and
its backward recomputes p from the lse: the backward kernel on CUDA, the
plain backward on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..common import on_cuda, on_meta
from . import kernel
from .ref import attention_bwd_ref, attention_ref


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        if on_meta(q, k, v):
            out, lse = kernel.flash_attention_meta(
                q.contiguous(), k.contiguous(), v.contiguous(),
                causal=causal, window=window, scale=scale)
        elif on_cuda(q, k, v):
            out, lse = kernel.flash_attention_cuda(
                q.contiguous(), k.contiguous(), v.contiguous(),
                causal=causal, window=window, scale=scale)
        else:
            out, lse = attention_ref(q, k, v, causal=causal, window=window,
                                     scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        kw = dict(causal=ctx.causal, window=ctx.window, scale=ctx.scale)
        if on_meta(q, k, v, dout):
            dq, dk, dv = kernel.flash_attention_bwd_meta(
                q.contiguous(), k.contiguous(), v.contiguous(), out, lse,
                dout.contiguous(), **kw)
        elif on_cuda(q, k, v, dout):
            dq, dk, dv = kernel.flash_attention_bwd_cuda(
                q.contiguous(), k.contiguous(), v.contiguous(), out, lse,
                dout.contiguous(), **kw)
        else:
            dq, dk, dv = attention_bwd_ref(q, k, v, out, lse, dout, **kw)
        return dq, dk, dv, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None, return_lse: bool = False):
    """Flash attention. q: (B, Hq, T, D), k/v: (B, Hkv, S, D).

    Causal masking is aligned bottom-right (query row i sits at absolute
    position ``S - T + i``).  Returns ``out`` (q.dtype), or ``(out, lse)``
    with an f32 ``lse`` when ``return_lse``; ``out`` is differentiable in
    q, k and v, ``lse`` is not.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    out, lse = _FlashAttention.apply(q, k, v, causal, window, scale)
    return (out, lse) if return_lse else out
