"""Public RWKV-6 op: the Hopper kernels (K6) on CUDA tensors, the plain
chunked version on CPU tensors.

The twin of ``repro/kernels/rwkv6/ops.py::rwkv6``.  The forward only: the
reference's backward is the vjp of its chunked XLA path
(``ops.py:90-96``), and the port's comes with RWKV training.  A CUDA call
whose inputs require grad raises rather than fall back to autograd over
the plain version.

Routing on CUDA, by dtype and length (not a setting):

* bf16 r/k/v with at least ``SM90_MIN_T`` tokens (prefill): the chunked
  tensor-core kernel, ``kernel.rwkv6_sm90_cuda``;
* f32 r/k/v (the chunked kernel takes bf16 r/k/v only), and bf16 below
  ``SM90_MIN_T`` tokens: the sequential kernel, ``kernel.rwkv6_cuda``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..common import on_cuda
from . import kernel
from .ref import rwkv6_chunked

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
    at -30); u: (H, D); s0: (B, H, D, D) or None (zeros).

    Returns ``(o: (B, H, T, D) in v.dtype, s_final: (B, H, D, D) f32)``.
    ``chunk`` is the plain version's chunk length; the kernels fix their
    own.
    """
    tensors = (r, k, v, log_w, u) + (() if s0 is None else (s0,))
    if not on_cuda(*tensors):
        return rwkv6_chunked(r, k, v, log_w, u, s0, chunk=chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "rwkv6 on CUDA has no backward kernel yet (it comes with RWKV "
            "training); call it under torch.no_grad()")
    b, h, t, d = r.shape
    if s0 is None:
        s0 = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
    r, k, v, log_w = (x.contiguous() for x in (r, k, v, log_w.float()))
    if r.dtype == torch.bfloat16 and t >= SM90_MIN_T:
        # TMA reads r/k/v/log_w from 16-byte aligned addresses: a view at
        # another offset is copied to fresh (aligned) memory
        r, k, v, log_w = (x if x.data_ptr() % 16 == 0 else x.clone()
                          for x in (r, k, v, log_w))
        run = kernel.rwkv6_sm90_cuda
    else:
        run = kernel.rwkv6_cuda
    return run(r, k, v, log_w, u.float().contiguous(),
               s0.float().contiguous())
