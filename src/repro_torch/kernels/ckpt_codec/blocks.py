"""The blockwise q8 layout — one definition shared by every codec path.

Three things implement "blockwise int8 with one f32 scale per BLOCK values":
the Pallas kernel (``kernel.py``), the jnp oracle (``ref.py``), and the
host-side wire codec (``repro.core.tiers``).  The layout constants and the
numpy reference live *here*, dependency-free (no jax import), so the host
codec and the device kernels cannot drift: ``tiers.py`` imports this module
directly and the kernel tests assert the Pallas/XLA outputs match it.

All functions operate on *flattened, padded* buffers of shape
(num_blocks, BLOCK), exactly like the kernels.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

BLOCK = 256  # values per quantization block (one f32 scale each)


def to_blocks_np(x: np.ndarray) -> Tuple[np.ndarray, int]:
    """Flatten + zero-pad to (nb, BLOCK) float32. Returns (blocks, orig_n)."""
    flat = np.ravel(x).astype(np.float32)
    n = flat.size
    nb = -(-max(n, 1) // BLOCK)
    blocks = np.zeros((nb, BLOCK), np.float32)
    blocks.reshape(-1)[:n] = flat
    return blocks, n


def quantize_np(blocks: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(nb, BLOCK) f32 -> (int8 codes (nb, BLOCK), f32 scales (nb, 1)).

    The numpy mirror of ``ref.quantize_ref`` / the Pallas quantize kernel:
    absmax/127 scale per block (1.0 for all-zero blocks), round-to-nearest,
    clip to [-127, 127].
    """
    blocks = blocks.astype(np.float32, copy=False)
    absmax = np.max(np.abs(blocks), axis=-1, keepdims=True)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(blocks / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_np(q: np.ndarray, scale: np.ndarray, n: int,
                  dtype) -> np.ndarray:
    """Invert :func:`quantize_np`: codes * scales, trimmed to ``n`` values.

    Float math is f32 (identical bit-for-bit to the device dequantize) and
    only the final cast goes to ``dtype``.
    """
    x = (q.astype(np.float32) * scale).reshape(-1)[:n]
    return x.astype(np.dtype(dtype))
