"""TrainState: f32 master params + AdamW state + step counter, the twin
of ``repro/train/state.py`` on one device (its logical-axis trees and
sharding specs have no counterpart here)."""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..configs.base import ModelConfig
from ..models import init_params
from ..optim import AdamWConfig, AdamWState, adamw_init


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    step: torch.Tensor


def make_train_state(cfg: ModelConfig,
                     generator: Optional[torch.Generator] = None,
                     opt_cfg: Optional[AdamWConfig] = None,
                     device="cuda") -> TrainState:
    """Params drawn from ``generator`` on ``device``, zero moments."""
    opt_cfg = opt_cfg or AdamWConfig()
    params = init_params(cfg, generator, device=device)
    return TrainState(params=params,
                      opt=adamw_init(params, compress=opt_cfg.compress_grads),
                      step=torch.zeros((), dtype=torch.int32, device=device))
