"""TrainState: f32 master params + AdamW state + step counter, with its
logical-axis trees and sharding specs, the twin of
``repro/train/state.py``."""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..configs.base import ModelConfig
from ..models import abstract_params, init_params, map_axes, param_specs
from ..optim import AdamWConfig, AdamWState, adamw_init, opt_state_axes
from ..sharding import FSDP_RULES, P, Rules, get_rules


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


def abstract_train_state(cfg: ModelConfig,
                         opt_cfg: Optional[AdamWConfig] = None):
    """(TrainState of ``meta`` tensors, its axes TrainState): shapes and
    dtypes with nothing allocated (``repro/train/state.py:31-50``)."""
    opt_cfg = opt_cfg or AdamWConfig()
    shapes, axes = abstract_params(cfg)

    def f32(ax, p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")

    def moments():
        return map_axes(f32, axes, shapes)

    scalar = torch.empty((), dtype=torch.int32, device="meta")
    state = TrainState(
        params=shapes,
        opt=AdamWState(mu=moments(), nu=moments(), count=scalar,
                       err=moments() if opt_cfg.compress_grads else None),
        step=scalar)
    state_axes = TrainState(
        params=axes, opt=opt_state_axes(axes, opt_cfg.compress_grads),
        step=())
    return state, state_axes


def train_state_specs(cfg: ModelConfig, mesh, state_shapes, state_axes,
                      rules: Optional[Rules] = None) -> TrainState:
    """PartitionSpec tree of the TrainState: params follow the model's
    rules; the moments and the residual always resolve against
    ``FSDP_RULES`` (ZeRO-1), whatever the model's rules
    (``repro/train/state.py:53-76``)."""
    rules = rules or get_rules(cfg.rules)
    opt, opt_ax = state_shapes.opt, state_axes.opt
    err = None
    if opt_ax.err is not None:
        err = param_specs(opt_ax.err, FSDP_RULES, mesh, opt.err)
    return TrainState(
        params=param_specs(state_axes.params, rules, mesh,
                           state_shapes.params),
        opt=AdamWState(mu=param_specs(opt_ax.mu, FSDP_RULES, mesh, opt.mu),
                       nu=param_specs(opt_ax.nu, FSDP_RULES, mesh, opt.nu),
                       count=P(), err=err),
        step=P())
