"""yi-6b [dense]: 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000
(llama-arch GQA).  [arXiv:2403.04652; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=4,
    d_ff=11008, vocab_size=64000,
    rope_theta=5000000.0,
    rules="tp", remat_policy="full",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="yi-tiny", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256,
        dtype="float32", rules="tp", remat_policy="none",
    )
