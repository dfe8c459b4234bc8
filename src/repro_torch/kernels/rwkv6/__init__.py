"""RWKV-6 time-mix recurrence: the Hopper kernels of K6 on CUDA tensors
(``csrc/rwkv6_sm90.cu`` for bf16 prefill, ``csrc/rwkv6.cu`` otherwise; see
``ops``), the plain chunked version on CPU tensors."""
from .ops import rwkv6
from .ref import LOG_W_MIN, rwkv6_chunked, rwkv6_ref

__all__ = ["rwkv6", "rwkv6_ref", "rwkv6_chunked", "LOG_W_MIN"]
