"""Parameter accounting for whole param trees (sharding specs come with the
multi-device slice)."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count from an init on the ``meta`` device (no
    allocation).  The port builds dense models only, so ``active_only``
    changes nothing."""
    from .transformer import init_params

    return sum(t.numel() for t in _leaves(init_params(cfg, None, "meta")))
