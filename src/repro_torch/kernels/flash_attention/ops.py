"""Public attention op: the Hopper kernel on CUDA tensors, the plain
version on CPU tensors.

Forward only: serving needs no gradient, and an input that requires one
raises.  The ``autograd.Function`` with the backward kernel comes with the
training path.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..common import on_cuda
from . import kernel
from .ref import attention_ref


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None, return_lse: bool = False):
    """Flash attention forward. q: (B, Hq, T, D), k/v: (B, Hkv, S, D).

    Causal masking is aligned bottom-right (query row i sits at absolute
    position ``S - T + i``).  Returns ``out`` (q.dtype), or ``(out, lse)``
    with an f32 ``lse`` when ``return_lse``.
    """
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "attention is forward-only in this port; the backward kernel "
            "comes with the training path")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if on_cuda(q, k, v):
        out, lse = kernel.flash_attention_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            window=window, scale=scale)
    else:
        out, lse = attention_ref(q, k, v, causal=causal, window=window,
                                 scale=scale)
    return (out, lse) if return_lse else out
