"""Public checkpoint-codec ops: flatten + zero-pad, then the Hopper kernel
on CUDA tensors or the plain version on CPU tensors.

The twin of ``repro/kernels/ckpt_codec/ops.py``.
``repro_torch.core.snapshot.snapshot_pytree(codec="q8"|"q8-delta")`` runs
:func:`quantize` / :func:`quantize_delta` on every float leaf on the card
before the device-to-host copy, and ``optim.adamw`` runs :func:`quantize`
+ :func:`dequantize` for its int8 gradient compression.  The host restart
path (``core/tiers.q8_chain_decode``) applies the same XOR + dequantize in
numpy, bit for bit.  :func:`rs_encode` is the device Reed-Solomon
parity (K5 on CUDA tensors); like the reference's, no commit path calls
it: ``core/tiers.py`` encodes the erasure-coded L1 fragments on the host
with ``rs.rs_encode_np``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ..common import on_cuda
from . import kernel as K
from . import ref as R
from . import rs_kernel as RS
from .blocks import BLOCK


def _to_blocks(x: torch.Tensor):
    """Flatten + zero-pad to (nb, BLOCK). Returns (blocks, orig_size).

    A contiguous tensor whose size is a multiple of BLOCK (and, on the
    card, whose data is 16-byte aligned) becomes a view, not a copy."""
    flat = x.reshape(-1)
    n = flat.numel()
    nb = -(-n // BLOCK)
    if nb * BLOCK != n:
        flat = F.pad(flat, (0, nb * BLOCK - n))
    elif flat.is_cuda and flat.data_ptr() % 16:
        flat = flat.clone()
    return flat.view(nb, BLOCK), n


def quantize(x: torch.Tensor):
    """Tensor -> (codes int8 (nb, BLOCK), scales f32 (nb, 1))."""
    blocks, _ = _to_blocks(x)
    if on_cuda(blocks):
        return K.quantize_cuda(blocks)
    return R.quantize_ref(blocks)


def quantize_delta(x: torch.Tensor, prev_q: torch.Tensor):
    """Tensor + previous codes -> (delta int8, scales f32, codes int8)."""
    blocks, _ = _to_blocks(x)
    if on_cuda(blocks, prev_q):
        return K.quantize_delta_cuda(blocks, prev_q)
    return R.quantize_delta_ref(blocks, prev_q)


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape: Sequence[int],
               dtype=torch.float32) -> torch.Tensor:
    """Codes + scales -> a tensor of ``shape`` and ``dtype``."""
    if on_cuda(q, scale):
        blocks = K.dequantize_cuda(q, scale, dtype)
    else:
        blocks = R.dequantize_ref(q, scale, dtype)
    n = 1
    for s in shape:
        n *= int(s)
    return blocks.reshape(-1)[:n].reshape(tuple(shape))


def undelta_dequantize(delta: torch.Tensor, prev_q: torch.Tensor,
                       scale: torch.Tensor, shape: Sequence[int],
                       dtype=torch.float32) -> torch.Tensor:
    """Invert a delta commit: codes = delta ^ prev_q, then dequantize."""
    return dequantize(torch.bitwise_xor(delta, prev_q), scale, shape, dtype)


def rs_encode(data_rows, m: int = 1) -> torch.Tensor:
    """Reed-Solomon parity: (k, stride) bytes -> (m, stride) uint8.

    The device twin of :func:`.rs.rs_encode_np`, bit for bit: the Hopper
    kernel on a CUDA tensor, the plain xtime version otherwise (a numpy
    array is taken as a CPU tensor)."""
    x = torch.as_tensor(data_rows)
    if on_cuda(x):
        return RS.rs_encode_cuda(x.to(torch.uint8).contiguous(), m)
    return RS.rs_encode_ref(x.to(torch.uint8), m)
