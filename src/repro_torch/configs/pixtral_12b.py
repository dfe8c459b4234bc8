"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 (pixtral-ViT + mistral-nemo backbone).  The vision frontend is
a STUB per the assignment: ``input_specs`` provides precomputed patch
embeddings (B, num_patches, d_model) that are projected and prepended to
the token sequence.  [hf:mistralai/Pixtral-12B-2409; unverified]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    head_dim=160, d_ff=14336, vocab_size=131072,
    rope_theta=1000000.0,
    frontend="patches", num_patches=256,
    rules="tp", remat_policy="full",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="pixtral-tiny", family="vlm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256,
        frontend="patches", num_patches=8,
        dtype="float32", rules="tp", remat_policy="none",
    )
