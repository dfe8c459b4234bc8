"""Parameter accounting for whole param trees (sharding specs come with the
multi-device slice)."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig

_EXPERT_KEYS = ("w_gu", "w_down")


def _leaves(tree, path=()):
    """(keys from the root, tensor) for every leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count from an init on the ``meta`` device (no
    allocation).  ``active_only``: each MoE expert leaf (``w_gu``,
    ``w_down`` under a ``moe`` key) counts ``int(n * k / E)`` of its n
    values, leaf by leaf, as the reference counts a token's active
    parameters (``repro/models/params.py:18-37``)."""
    from .transformer import init_params

    frac = (cfg.experts_per_token / cfg.num_experts) if cfg.num_experts \
        else 1.0
    total = 0
    for path, leaf in _leaves(init_params(cfg, None, "meta")):
        n = leaf.numel()
        if active_only and cfg.num_experts and "moe" in path and any(
                k in _EXPERT_KEYS for k in path):
            n = int(n * frac)
        total += n
    return total
