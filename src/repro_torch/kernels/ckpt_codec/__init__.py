"""Checkpoint codec: the blockwise q8 layout and its device ops.

``blocks`` (the blockwise q8 layout + numpy reference) and ``rs`` (the
GF(2^8) Reed-Solomon numpy reference) are verbatim copies of the reference
package's modules; ``core/tiers.py`` imports them.  ``ops`` holds the
device codec (quantize / quantize_delta / dequantize: the Hopper kernels
of ``csrc/codec.cu``) and the device Reed-Solomon encode (``rs_encode``:
``csrc/rs.cu``) on CUDA tensors, their plain versions (``ref``,
``rs_kernel.rs_encode_ref``) on CPU tensors.
"""
from __future__ import annotations

from .blocks import BLOCK, dequantize_np, quantize_np, to_blocks_np
from .ops import (dequantize, quantize, quantize_delta, rs_encode,
                  undelta_dequantize)
from .rs import (join_rows, rs_decode_np, rs_encode_np, rs_generator_matrix,
                 split_rows)

__all__ = ["BLOCK", "to_blocks_np", "quantize_np", "dequantize_np",
           "quantize", "quantize_delta", "dequantize", "undelta_dequantize",
           "rs_encode",
           "rs_encode_np", "rs_decode_np", "rs_generator_matrix",
           "split_rows", "join_rows"]
