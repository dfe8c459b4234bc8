"""train_step factory: loss and gradients through autograd, microbatch
gradient accumulation, AdamW update (the twin of ``repro/train/step.py``).

Gradients land in f32 buffers of the parameters' layout.  Each layer of a
stacked leaf enters the loss as a leaf tensor of its own (a detached view
of the master weight), whose ``.grad`` is preset to the matching slice of
the buffer, so autograd accumulates every layer's gradient in place: no
full-size temporary per layer (which indexing a stacked leaf that itself
requires grad would build) and no copy afterwards.  Microbatches
accumulate into the same buffers.

Data parallel over a process group (``group``): each rank scores its
slice of the global batch, its cross-entropy taken over the whole batch's
unmasked targets (an all-reduced count) and its aux loss over the rank
count, so the gradients all-reduced (summed) over the group, one
all-reduce a leaf, are the whole batch's.  They are all-reduced before
clipping and compression, which the optimizer applies to the global
gradient, so every rank takes the same update and the replicas stay
bit-equal.  The reported loss is the all-reduced one.

Microbatches are the reference's: the i-th is the i-th contiguous block
of the global batch's rows, scored over its own unmasked targets, and the
loss and gradient are the microbatches' mean.  Each rank runs its own
rows in that many equal chunks (a device's work in each step of the
reference's loop), each scored over the count of the microbatch that
holds it.

Split over a mesh too (``mesh``, ``sharding/tp.py``): the params,
moments and gradients are the rank's boxes (``models.shard_params``), the
loss runs under ``use_rules(mesh, rules)`` (its collectives over the
model ranks, and under ``FSDP_RULES`` each layer's gathers of its
"data"-split leaves, whose backward reduce-scatters their gradients over
the data ranks), the other gradients are all-reduced over the "data"
axis, and the clip's global norm sums each leaf's squares over the axes
that split it, a whole leaf's once (``models.param_split``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from ..configs.base import ModelConfig
from ..models import loss_fn, param_split
from ..models.params import tree_at, tree_paths
from ..optim import AdamWConfig, adamw_update
from ..sharding import get_rules, tp, use_rules
from .state import TrainState


def _grad_leaf(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    leaf = p.detach().requires_grad_()
    leaf.grad = g
    return leaf


def _bind(params, grads, stacked: bool = False):
    """The params tree for the loss: stacked leaves become lists of
    per-layer leaves (``transformer._layer`` indexes either)."""
    if isinstance(params, dict):
        return {k: _bind(params[k], grads[k], stacked or k == "stack")
                for k in params}
    if stacked:
        return [_grad_leaf(params[i], grads[i])
                for i in range(params.shape[0])]
    return _grad_leaf(params, grads)


def zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: zeros_like_tree(v) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)


def compute_grads(cfg: ModelConfig, params, batch, grads=None, **loss_kw):
    """Loss and gradient of ``loss_fn`` at ``params`` (``loss_kw`` passed
    on to it); the gradient is added into ``grads`` (f32 buffers of the
    params' layout, made zero when not given).  Returns (loss, metrics,
    grads)."""
    if grads is None:
        grads = zeros_like_tree(params)
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, _bind(params, grads), batch, **loss_kw)
        loss.backward()
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _grads(cfg: ModelConfig, params, batch, group=None, split=None,
           microbatches: int = 1):
    """The loss and gradient of this rank's rows of the global batch in
    ``microbatches`` chunks, and with a ``group`` (data parallel) the
    gradient and the loss all-reduced over it.  Chunk j of data rank r
    holds the global rows from (r n + j) c on (c rows a chunk), in the
    reference's microbatch (r n + j) // R of R ranks: it is scored over
    that microbatch's unmasked targets (one all-reduce of the counts).
    A leaf that ``split`` (``models.param_split``) marks split over
    "data" holds the data ranks' summed gradient of its box already (its
    gather's backward reduce-scattered it) and is not all-reduced
    again."""
    n = microbatches
    b = batch["tokens"].shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    ranks, rank = ((dist.get_world_size(group), dist.get_rank(group))
                   if group is not None else (1, 0))
    chunks = [({k: v.chunk(n)[j] for k, v in batch.items()},
               (rank * n + j) // ranks) for j in range(n)]
    counts = torch.zeros(n, device=batch["labels"].device)
    for mb, i in chunks:
        counts[i] += (mb["labels"][:, 1:] >= 0).sum()
    if group is not None:
        dist.all_reduce(counts, group=group)
    grads, loss = None, 0.0
    for mb, i in chunks:
        mb_loss, metrics, grads = compute_grads(
            cfg, params, mb, grads, token_total=counts[i], ranks=ranks)
        loss = loss + mb_loss
    if n > 1:
        with torch.no_grad():
            for _, g in tree_paths(grads):
                g.div_(n)
        loss, metrics = loss / n, {}
    if group is not None:
        for path, g in tree_paths(grads):
            if split is None or "data" not in tree_at(split, path):
                dist.all_reduce(g, group=group)
        dist.all_reduce(loss, group=group)
    return loss, metrics, grads


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                    schedule: Optional[Callable] = None,
                    microbatches: int = 1, group=None,
                    mesh=None, rules=None) -> Callable:
    """``group``: the process group the step is data parallel over (None:
    one rank).  ``mesh``: a ("data", "model") mesh the step is split over
    instead (its "data" axis taking ``group``'s place); the state holds
    the rank's shards, under ``rules`` (default the config's)."""
    opt_cfg = opt_cfg or AdamWConfig()
    rules = rules or get_rules(cfg.rules)
    split = groups = None
    if mesh is not None:
        if group is not None:
            raise ValueError("give a group or a mesh, not both")
        tp.check_model_axis(cfg, tp.axis_size(mesh), rules,
                            tp.axis_size(mesh, "data"))
        split = param_split(cfg, mesh, rules)
        if opt_cfg.compress_grads and any(a for _, a in tree_paths(split)):
            raise ValueError("compressed gradients are not split over "
                             "the mesh's axes")
        groups = {a: mesh.get_group(a) for a in mesh.mesh_dim_names
                  if tp.axis_size(mesh, a) > 1}
        if tp.axis_size(mesh, "data") > 1:
            group = mesh.get_group("data")

    def train_step(state: TrainState, batch: Dict) -> tuple:
        """(state, batch of tensors) -> (state, metrics); the params and
        moments are updated in place, ``state.step`` is a new tensor."""
        with use_rules(mesh, rules):
            return _step(state, batch)

    def _step(state: TrainState, batch: Dict) -> tuple:
        params = state.params
        loss, metrics, grads = _grads(cfg, params, batch, group, split,
                                      microbatches)
        _, new_opt, opt_metrics = adamw_update(
            grads, state.opt, params, opt_cfg, schedule, split=split,
            groups=groups)
        del grads
        new_state = TrainState(params=params, opt=new_opt,
                               step=state.step + 1)
        return new_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step

