"""Public RG-LRU op: the Hopper kernel (K7) on CUDA tensors, the plain
chunked version on CPU tensors.

The twin of ``repro/kernels/rglru/ops.py::rglru``.  The forward only: the
reference's backward is the analytic reverse scan of ``ops._rglru_bwd``
(``ops.py:54-86``), and the port's comes with hybrid training.  A CUDA
call whose inputs require grad raises rather than fall back to autograd
over the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..common import on_cuda
from . import kernel
from .ref import rglru_chunked


def rglru(log_a: torch.Tensor, g: torch.Tensor,
          h0: Optional[torch.Tensor] = None):
    """RG-LRU core: h_t = exp(log_a_t) * h_{t-1} + g_t.  log_a, g:
    (B, T, D), log_a <= 0; h0: (B, D) or None (zeros).

    Returns ``(h: (B, T, D) in g.dtype, h_final: (B, D) f32)``.
    """
    tensors = (log_a, g) + (() if h0 is None else (h0,))
    if not on_cuda(*tensors):
        return rglru_chunked(log_a, g, h0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "rglru on CUDA has no backward kernel yet (it comes with hybrid "
            "training); call it under torch.no_grad()")
    return kernel.rglru_cuda(
        log_a.float().contiguous(), g.contiguous(),
        None if h0 is None else h0.float().contiguous())
