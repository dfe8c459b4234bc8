"""Checkpoint codec layout shared with the host wire codec.

``blocks`` (the blockwise q8 layout + numpy reference) and ``rs`` (the
GF(2^8) Reed-Solomon numpy reference) are verbatim copies of the reference
package's modules; ``core/tiers.py`` imports them.  The device codec
kernels (quantize / quantize_delta / dequantize) come with the training
slice.
"""
from __future__ import annotations

from .blocks import BLOCK, dequantize_np, quantize_np, to_blocks_np
from .rs import (join_rows, rs_decode_np, rs_encode_np, rs_generator_matrix,
                 split_rows)

__all__ = ["BLOCK", "to_blocks_np", "quantize_np", "dequantize_np",
           "rs_encode_np", "rs_decode_np", "rs_generator_matrix",
           "split_rows", "join_rows"]
