"""Public RWKV-6 op: the Hopper kernel (K6) on CUDA tensors, the plain
chunked version on CPU tensors.

The twin of ``repro/kernels/rwkv6/ops.py::rwkv6``.  The forward only: the
reference's backward is the vjp of its chunked XLA path
(``ops.py:90-96``), and the port's comes with RWKV training.  A CUDA call
whose inputs require grad raises rather than fall back to autograd over
the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..common import on_cuda
from . import kernel
from .ref import rwkv6_chunked


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          log_w: torch.Tensor, u: torch.Tensor,
          s0: Optional[torch.Tensor] = None, *, chunk: int = 64):
    """RWKV-6 time-mix core. r/k/v/log_w: (B, H, T, D), log_w <= 0 (clamped
    at -30); u: (H, D); s0: (B, H, D, D) or None (zeros).

    Returns ``(o: (B, H, T, D) in v.dtype, s_final: (B, H, D, D) f32)``.
    ``chunk`` is the plain version's chunk length; the kernel needs none.
    """
    tensors = (r, k, v, log_w, u) + (() if s0 is None else (s0,))
    if not on_cuda(*tensors):
        return rwkv6_chunked(r, k, v, log_w, u, s0, chunk=chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "rwkv6 on CUDA has no backward kernel yet (it comes with RWKV "
            "training); call it under torch.no_grad()")
    b, h, _, d = r.shape
    if s0 is None:
        s0 = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
    return kernel.rwkv6_cuda(
        r.contiguous(), k.contiguous(), v.contiguous(),
        log_w.float().contiguous(), u.float().contiguous(),
        s0.float().contiguous())
