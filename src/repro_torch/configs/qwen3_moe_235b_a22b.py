"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) MoE 128
experts top-8, per-expert d_ff=1536, vocab=151936 (EP-heavy).
[hf:Qwen/Qwen3-30B-A3B; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
    d_ff=1536, vocab_size=151936,
    ffn="moe", num_experts=128, experts_per_token=8, moe_d_ff=1536,
    rope_theta=1000000.0,
    rules="fsdp", remat_policy="full",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-tiny", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=48, vocab_size=256,
        ffn="moe", num_experts=8, experts_per_token=2, moe_d_ff=48,
        dtype="float32", rules="tp", remat_policy="none",
    )
