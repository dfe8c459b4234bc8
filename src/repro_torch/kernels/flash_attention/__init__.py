from .ops import attention
from .ref import attention_ref

__all__ = ["attention", "attention_ref"]
