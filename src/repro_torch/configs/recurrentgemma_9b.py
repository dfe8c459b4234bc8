"""recurrentgemma-9b [hybrid] (Griffin): 38L d_model=4096 16H (GQA kv=1,
MQA) d_ff=12288, RG-LRU + local attention 1:2, window 2048, vocab=256000.
38 layers = 12 x (rec, rec, attn) scanned super-layers + 2 tail rec layers.
Sub-quadratic (O(window) attention state): runs the long_500k cell.
[arXiv:2402.19427; unverified]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    head_dim=256, d_ff=12288, vocab_size=256000,
    mixer="rglru_hybrid", ffn="geglu",
    pattern=("rec", "rec", "attn"), tail_layers=("rec", "rec"),
    window=2048, rnn_width=4096, conv1d_width=4,
    rules="tp", remat_policy="full",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-tiny", family="hybrid",
        num_layers=5, d_model=64, num_heads=4, num_kv_heads=1,
        head_dim=16, d_ff=128, vocab_size=256,
        mixer="rglru_hybrid", ffn="geglu",
        pattern=("rec", "rec", "attn"), tail_layers=("rec", "rec"),
        window=16, rnn_width=64, conv1d_width=4,
        dtype="float32", rules="tp", remat_policy="none",
    )
