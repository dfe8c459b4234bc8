"""AdamW with global-norm clipping and optional int8 gradient compression
with error feedback: the twin of ``repro/optim/adamw.py``.

The reference's operation order is kept: clip, compress, then the moment
updates and the parameter step.  Unlike the reference, which returns new
arrays, the update works in place on the f32 parameters, moments, grads
and residuals, one layer slice of a stacked leaf at a time, so that no
temporary of a whole leaf exists (``stack/b0/ffn/w_gu`` of qwen2.5-3b is
6.5 GB of f32).  ``opt_state_axes`` gives the state's logical axes, which
``train/state.py`` resolves against FSDP rules (ZeRO-1) whatever the
model's rules.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from ..kernels.ckpt_codec import BLOCK, dequantize, quantize
from ..models.params import tree_at, tree_paths


class AdamWState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor
    err: Any                  # error-feedback residual (None if no compress)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    compress_grads: bool = False    # int8 block-quantized grads + EF


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  final_frac: float = 0.1) -> Callable:
    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi
                                                                   * t))
        return torch.where(step < warmup, warm, base_lr * cos)
    return schedule


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def adamw_init(params, compress: bool = False) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    count = torch.zeros((), dtype=torch.int32,
                        device=next(tree_paths(params))[1].device)
    return AdamWState(mu=_map(zeros, params), nu=_map(zeros, params),
                      count=count,
                      err=_map(zeros, params) if compress else None)


def _slices(path, *leaves):
    """Layer slices of the leaves under ``stack`` (views on the leading
    layer axis), each whole other leaf once.  A slice is used only when
    its size is a multiple of BLOCK, so that the codec's blocks are those
    of the whole leaf."""
    lead = leaves[0]
    if path[0] == "stack" and lead.dim() > 1 and \
            (lead[0].numel() % BLOCK) == 0:
        for i in range(lead.shape[0]):
            yield tuple(t[i] for t in leaves)
    else:
        yield leaves


def _global_norm(grads, split=None, groups=None) -> torch.Tensor:
    """The f32 L2 norm of every gradient leaf.  A leaf split over mesh
    axes (``split``: a tree of the axes that split each leaf,
    ``models.param_split``; ``groups``: each axis's process group) holds
    a box of the gradient on each rank: the squares of the leaves split
    over the same axes are summed, then over each of those axes' groups; a
    whole leaf, equal on every rank, counts once."""
    sums = {}
    for path, g in tree_paths(grads):
        axes = () if split is None else tree_at(split, path)
        sq = torch.linalg.vector_norm(g, dtype=torch.float32).square()
        sums[axes] = sq if axes not in sums else sums[axes] + sq
    total = None
    for axes, sq in sums.items():
        for a in axes:
            dist.all_reduce(sq, group=groups[a])
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _compress_decompress_(g: torch.Tensor, err: torch.Tensor) -> None:
    """int8 block-quantize + dequantize with error feedback, in place:
    ``err`` becomes g + err - g_hat and ``g`` becomes g_hat (the
    reference's ``_compress_decompress``, ``adamw.py:62-74``)."""
    err.add_(g)                                     # g_comp
    q, scale = quantize(err)
    g.copy_(dequantize(q, scale, g.shape, torch.float32))
    err.sub_(g)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig,
                 schedule: Optional[Callable] = None, split=None,
                 groups=None):
    """One AdamW step on f32 ``params``, in place; ``grads`` (f32) are
    clipped (and compressed) in place.  Returns (params, new_state,
    metrics), the same tensors as given.  ``split`` / ``groups``: the
    mesh axes that split each leaf and their process groups, for the
    clip's global norm (``_global_norm``)."""
    count = state.count + 1
    gnorm = _global_norm(grads, split, groups)
    if cfg.grad_clip:
        clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
        for _, g in tree_paths(grads):
            g.mul_(clip)
    if cfg.compress_grads and state.err is not None:
        for (path, g), (_, e) in zip(tree_paths(grads), tree_paths(state.err)):
            for gs, es in _slices(path, g, e):
                _compress_decompress_(gs, es)

    lr = schedule(count) if schedule is not None else cfg.lr
    countf = count.float()
    b1c = 1 - torch.pow(torch.full_like(countf, cfg.b1), countf)
    b2c = 1 - torch.pow(torch.full_like(countf, cfg.b2), countf)

    trees = (params, state.mu, state.nu, grads)
    for leaves in zip(*(tree_paths(t) for t in trees)):
        path = leaves[0][0]
        for p, m, n, g in _slices(path, *(t for _, t in leaves)):
            m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
            n.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
            step = (m / b1c).div_((n / b2c).sqrt_().add_(cfg.eps))
            step.add_(p, alpha=cfg.weight_decay)
            p.sub_(step.mul_(lr))
    new_state = AdamWState(mu=state.mu, nu=state.nu, count=count,
                           err=state.err)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}


def opt_state_axes(param_axes, compress: bool = False) -> AdamWState:
    """Logical axes of the optimizer state: the params' for each moment
    (and the residual), ``()`` for the count
    (``repro/optim/adamw.py:115-118``)."""
    return AdamWState(mu=param_axes, nu=param_axes, count=(),
                      err=param_axes if compress else None)
