"""Plain PyTorch version of the checkpoint codec (K1-K3).

The twin of ``repro/kernels/ckpt_codec/ref.py``: blockwise int8 with one
f32 scale per ``BLOCK`` values, and the XOR delta against the previous
codes.  Every function takes the flattened, zero-padded ``(nb, BLOCK)``
layout that ``ops`` builds.  The CPU path and the card checks use it; its
codes equal ``blocks.quantize_np`` bit for bit (IEEE division ``x /
scale``, round half to even, ``absmax / 127`` in f32).
"""
from __future__ import annotations

import torch

from .blocks import BLOCK

__all__ = ["BLOCK", "quantize_ref", "dequantize_ref", "xor_delta_ref",
           "quantize_delta_ref"]


def quantize_ref(x: torch.Tensor):
    """(nb, BLOCK) float -> (int8 codes (nb, BLOCK), f32 scales (nb, 1))."""
    x = x.float()
    absmax = x.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the IEEE quotient
    scale = torch.where(absmax > 0,
                        absmax / torch.full_like(absmax, 127.0), 1.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_ref(q: torch.Tensor, scale: torch.Tensor,
                   dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def xor_delta_ref(curr_q: torch.Tensor, prev_q: torch.Tensor) -> torch.Tensor:
    """Bitwise delta between two int8 code buffers (identical -> zeros)."""
    return torch.bitwise_xor(curr_q, prev_q)


def quantize_delta_ref(x: torch.Tensor, prev_q: torch.Tensor):
    """Fused quantize + XOR delta. Returns (delta, scales, codes)."""
    q, scale = quantize_ref(x)
    return torch.bitwise_xor(q, prev_q), scale, q
