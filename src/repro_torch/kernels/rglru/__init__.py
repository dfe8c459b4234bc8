"""RG-LRU diagonal recurrence: the Hopper kernel K7 (``csrc/rglru.cu``)
on CUDA tensors, the plain chunked version on CPU tensors."""
from .ops import rglru
from .ref import rglru_chunked, rglru_ref

__all__ = ["rglru", "rglru_ref", "rglru_chunked"]
