from .ops import attention
from .ref import attention_bwd_ref, attention_ref

__all__ = ["attention", "attention_ref", "attention_bwd_ref"]
