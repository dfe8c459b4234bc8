from .base import (ALL_SHAPES, ARCH_IDS, DECODE_32K, LONG_500K, PREFILL_32K,
                   TRAIN_4K, ModelConfig, ShapeConfig, get_config, get_shape,
                   shapes_for)

__all__ = ["ModelConfig", "ShapeConfig", "get_config", "get_shape",
           "shapes_for", "ARCH_IDS", "ALL_SHAPES", "TRAIN_4K", "PREFILL_32K",
           "DECODE_32K", "LONG_500K"]
