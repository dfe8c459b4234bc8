"""Model / run configuration system.

``ModelConfig`` is a frozen dataclass describing one architecture; the ten
assigned architectures each ship a module ``configs/<id>.py`` exposing
``CONFIG`` (full size) and ``tiny()`` (reduced same-family config for CPU
smoke tests).  ``get_config(name)`` resolves either.

Input shapes (the assignment's four cells) are described by ``ShapeConfig``
and produced by ``shapes_for(arch)`` -- ``long_500k`` is only emitted for
sub-quadratic archs (SSM / hybrid), per the assignment.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

FAMILIES = ("dense", "moe", "audio", "vlm", "ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | audio | vlm | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    mixer: str = "attention"         # attention | rwkv6 | rglru_hybrid
    ffn: str = "swiglu"              # swiglu | geglu | moe | rwkv_cmix
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    moe_d_ff: int = 0                # per-expert hidden dim (0 -> d_ff)
    router_aux_coef: float = 0.01
    # --- attention ---
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None     # sliding window (local attention)
    logit_softcap: float = 0.0
    # --- hybrid (RG-LRU) ---
    pattern: Tuple[str, ...] = ()    # e.g. ("rec", "rec", "attn"), scanned
    tail_layers: Tuple[str, ...] = ()  # layers appended after the scan
    rnn_width: int = 0               # RG-LRU state width (0 -> d_model)
    conv1d_width: int = 4
    # --- rwkv6 ---
    rwkv_head_dim: int = 64
    # --- encoder-decoder ---
    encoder_layers: int = 0          # > 0 -> enc-dec (audio family)
    # --- frontend ---
    frontend: str = "token"          # token | frames | patches
    num_patches: int = 256           # VLM stub: patch embeddings per image
    num_frames: int = 512            # audio stub: source frames
    # --- numerics / distribution ---
    dtype: str = "bfloat16"
    kv_quant: bool = False           # int8 KV cache (per-position scales)
    rules: str = "tp"                # tp | fsdp | seq (sharding rule set)
    remat_policy: str = "full"       # full | dots | none
    scan_layers: bool = True

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 so the lm-head / embedding shard evenly
        on any mesh axis (hillclimb H4: a 256206-row table replicates, a
        256256-row one shards 16 ways; the tail logits are masked -inf)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def resolved_rnn_width(self) -> int:
        return self.rnn_width or self.d_model

    @property
    def resolved_moe_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def subquadratic(self) -> bool:
        """True when decode state is O(1)/O(window) in sequence length."""
        return self.mixer in ("rwkv6", "rglru_hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (exact for our model definitions)."""
        from repro_torch.models.params import count_params  # lazy: avoids cycle
        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.params import count_params
        return count_params(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                        # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                        # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524288, 1)

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)

ARCH_IDS = (
    "dbrx-132b", "qwen3-moe-235b-a22b", "seamless-m4t-medium", "yi-6b",
    "phi3-medium-14b", "deepseek-7b", "qwen2.5-3b", "pixtral-12b",
    "rwkv6-7b", "recurrentgemma-9b",
)


def _module(name: str):
    mod = name.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str, tiny: bool = False) -> ModelConfig:
    """Resolve ``--arch`` ids; ``tiny=True`` gives the reduced smoke config."""
    m = _module(name)
    return m.tiny() if tiny else m.CONFIG


def shapes_for(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """The assignment's shape cells valid for this arch.

    ``long_500k`` needs sub-quadratic attention: emitted only for SSM /
    hybrid archs (rwkv6-7b, recurrentgemma-9b); pure full-attention archs
    skip it (recorded in DESIGN.md SS4 and the roofline table).
    """
    shapes = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.subquadratic:
        shapes.append(LONG_500K)
    return tuple(shapes)


def get_shape(name: str) -> ShapeConfig:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
