"""phi3-medium-14b [dense]: 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352 (RoPE SwiGLU GQA).  40 heads / kv=10 do not divide the 16-way
model axis: the fused projection dims (40*128=5120) still shard evenly, but
per-head activation constraints fall back to replication -- GSPMD resolves
the attention einsums around the sharded projections (see DESIGN.md SS5;
the proper fix, padding to 48 heads, is a documented hillclimb option).
[arXiv:2404.14219; unverified]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=10,
    d_ff=17920, vocab_size=100352,
    rules="tp", remat_policy="full",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="phi3-tiny", family="dense",
        num_layers=2, d_model=80, num_heads=5, num_kv_heads=5,
        d_ff=160, vocab_size=256,
        dtype="float32", rules="tp", remat_policy="none",
    )
