"""RG-LRU diagonal recurrence: the Hopper kernels K7 on CUDA tensors
(``csrc/rglru_sm90.cu``, loads by TMA, for prefill; ``csrc/rglru.cu`` for
shorter calls; their backwards ``csrc/rglru_bwd_sm90.cu`` and
``csrc/rglru_bwd.cu``, routed the same way), the plain chunked version on
CPU tensors."""
from .ops import rglru
from .ref import rglru_chunked, rglru_ref

__all__ = ["rglru", "rglru_ref", "rglru_chunked"]
