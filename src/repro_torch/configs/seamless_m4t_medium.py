"""seamless-m4t-medium [audio]: enc-dec, 12L encoder + 12L decoder,
d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.  The speech frontend is a
STUB per the assignment: ``input_specs`` provides precomputed frame
embeddings (B, num_frames, d_model).  [arXiv:2308.11596; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    num_layers=12, encoder_layers=12,
    d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=256206,
    frontend="frames", num_frames=512,
    rules="tp", remat_policy="full",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="seamless-tiny", family="audio",
        num_layers=2, encoder_layers=2,
        d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256,
        frontend="frames", num_frames=16,
        dtype="float32", rules="tp", remat_policy="none",
    )
