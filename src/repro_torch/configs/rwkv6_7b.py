"""rwkv6-7b [ssm] (Finch): 32L d_model=4096 (attention-free) d_ff=14336
vocab=65536 -- data-dependent decay linear recurrence, head_dim=64.
Sub-quadratic: runs the long_500k cell.  [arXiv:2404.05892; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    num_layers=32, d_model=4096, num_heads=64, num_kv_heads=64,
    d_ff=14336, vocab_size=65536,
    mixer="rwkv6", ffn="rwkv_cmix", rwkv_head_dim=64,
    rules="tp", remat_policy="full",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-tiny", family="ssm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256,
        mixer="rwkv6", ffn="rwkv_cmix", rwkv_head_dim=16,
        dtype="float32", rules="tp", remat_policy="none",
    )
