"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) MoE 16 experts top-4,
per-expert d_ff=10752, vocab=100352 (fine-grained MoE).
[hf:databricks/dbrx-base; unverified]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=10752, vocab_size=100352,
    ffn="moe", num_experts=16, experts_per_token=4, moe_d_ff=10752,
    rope_theta=500000.0,
    rules="fsdp", remat_policy="full",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b-tiny", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=96, vocab_size=256,
        ffn="moe", num_experts=4, experts_per_token=2, moe_d_ff=96,
        dtype="float32", rules="tp", remat_policy="none",
    )
