"""deepseek-7b [dense]: 30L d_model=4096 32H (MHA, kv=32) d_ff=11008
vocab=102400 (llama-arch).  [arXiv:2401.02954; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    num_layers=30, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=11008, vocab_size=102400,
    rules="tp", remat_policy="full",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="deepseek-tiny", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256,
        dtype="float32", rules="tp", remat_policy="none",
    )
