"""Tensor parallelism over the mesh's "model" axis: the reference's
``TP_RULES`` splits of heads, kv_heads, ff and the padded vocab, with
plain local shards and explicit collectives.

The reference names a sharding and lets GSPMD partition the step.  Here
each rank holds plain tensors, its box of every parameter leaf
(``models.params.shard_params``: the boxes of
``NamedSharding(mesh, param_specs(...))``), and the model code calls the
collective that GSPMD would insert where the reference constrains an
activation:

* ``enter(x)``: identity forward, all-reduce backward (Megatron's ``f``),
  on the replicated input of a column-parallel product (q / k / v, gate /
  up, the LM head), whose backward gives each rank a partial dx;
* ``reduce(x)``: all-reduce forward, identity backward (Megatron's
  ``g``), on the partial sums a rank holds: a row-parallel product's
  output (``o @ wo``, ``h @ w_down``), the vocab-parallel embedding, the
  cross-entropy's sums over vocab shards;
* ``all_max`` and ``argmax``: the max and the greedy argmax over vocab
  shards (the argmax takes the lowest index among equal maxima, as
  ``torch.argmax`` does).

Every collective is an ``all_reduce``: gloo on CUDA tensors (several
ranks on one card) offers ``all_reduce`` and ``broadcast`` only.  All are
the identity when no mesh with a "model" axis of more than one rank is
active (``use_rules(mesh, rules)``), so the one-process path is unchanged.
The model reads its local head counts from the shards' shapes.

Only the dense token decoders are split (``check_model_axis``); the
reference's kv_seq fallback, MoE experts, the recurrent "rnn" axis, the
encoder-decoder, the frontends, ``FSDP_RULES``, the int8 cache and
compressed gradients under "model" raise.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from .rules import active_rules

AXIS = "model"


class ModelAxis(NamedTuple):
    group: object          # the process group of this rank's model ranks
    size: int
    rank: int              # this rank's coordinate on the axis


def axis_size(mesh, name: str = AXIS) -> int:
    """The size of ``mesh``'s axis ``name`` (1 when it has none)."""
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if mesh is None or name not in names:
        return 1
    return int(mesh.mesh.shape[names.index(name)])


def axis_rank(mesh, name: str = AXIS) -> int:
    """This rank's coordinate on ``mesh``'s axis ``name`` (0 when it has
    none)."""
    if axis_size(mesh, name) == 1:
        return 0
    return int(mesh.get_local_rank(name))


def mesh_axis(mesh) -> Optional[ModelAxis]:
    """``mesh``'s "model" axis, or None when it has none or one rank."""
    size = axis_size(mesh)
    if size == 1:
        return None
    return ModelAxis(mesh.get_group(AXIS), size, axis_rank(mesh))


def model_axis() -> Optional[ModelAxis]:
    """The "model" axis of the active mesh (``use_rules``), or None."""
    pair = active_rules()
    return None if pair is None else mesh_axis(pair[0])


def check_model_axis(cfg, size: int, rules=None) -> None:
    """Raise ``ValueError`` unless ``cfg`` splits over a "model" axis of
    ``size`` ranks: a dense attention decoder over tokens with a bf16 / f32
    cache under ``TP_RULES``, whose heads, kv heads, d_ff and padded vocab
    the size divides.  (The reference would fall back, e.g. to splitting
    the cache over kv_seq when the kv heads do not divide; those are later
    slices.)"""
    if size == 1:
        return
    from .rules import TP_RULES

    later = []
    if cfg.mixer != "attention":
        later.append(f"the {cfg.mixer} mixer")
    if cfg.ffn == "moe":
        later.append("MoE experts")
    if cfg.is_encdec or cfg.frontend != "token":
        later.append(f"the {cfg.frontend} frontend")
    if cfg.kv_quant:
        later.append("the int8 KV cache")
    if rules is not None and rules != TP_RULES:
        later.append("rules other than TP_RULES")
    if later:
        raise ValueError(f"{cfg.name}: the 'model' axis is not split for "
                         f"{', '.join(later)}")
    for what, n in (("heads", cfg.num_heads), ("kv heads", cfg.num_kv_heads),
                    ("d_ff", cfg.d_ff), ("padded vocab", cfg.padded_vocab)):
        if n % size:
            raise ValueError(f"{cfg.name}: a 'model' axis of {size} does not "
                             f"divide its {n} {what}")


# --------------------------------------------------------------------------
# the two collectives with their gradients
# --------------------------------------------------------------------------
def _all_reduce_(x: torch.Tensor, group, op=None) -> torch.Tensor:
    dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=group)
    return x


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        return _all_reduce_(dx.contiguous().clone(), ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def enter(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel product: x as it is, its gradient
    summed over the model ranks."""
    ax = model_axis()
    if ax is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _Enter.apply(x, ax.group)


def reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum of every model rank's ``x`` (its gradient passed on as it
    is).  With no gradient to carry, ``x`` itself is summed in place:
    callers pass a fresh partial result."""
    ax = model_axis()
    if ax is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _Reduce.apply(x, ax.group)
    return _all_reduce_(x if x.is_contiguous() else x.contiguous(), ax.group)


def all_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over the model ranks of ``x`` (no gradient)."""
    ax = model_axis()
    x = x.detach()
    if ax is None:
        return x
    return _all_reduce_(x.contiguous().clone(), ax.group, dist.ReduceOp.MAX)


def vocab_offset(local: int) -> int:
    """The global index of this rank's first vocab row (``local`` rows a
    rank, the padded vocab split in order over the model ranks)."""
    ax = model_axis()
    return 0 if ax is None else ax.rank * local


def argmax(logits: torch.Tensor) -> torch.Tensor:
    """The greedy argmax over the last axis of vocab-sharded ``logits``
    (global indices), the lowest index among equal maxima."""
    ax = model_axis()
    if ax is None:
        return torch.argmax(logits, -1)
    local_max, local_idx = torch.max(logits, -1)
    top = _all_reduce_(local_max.clone(), ax.group, dist.ReduceOp.MAX)
    idx = local_idx.long() + ax.rank * logits.shape[-1]
    # a rank without the max offers an index past every vocab row
    none = torch.full_like(idx, ax.size * logits.shape[-1])
    cand = torch.where(local_max == top, idx, none)
    return _all_reduce_(cand, ax.group, dist.ReduceOp.MIN)


# --------------------------------------------------------------------------
# the "data" axis of a serving batch
# --------------------------------------------------------------------------
def data_rows(batch: int, mesh) -> slice:
    """This rank's rows of a global batch of ``batch`` sequences on
    ``mesh``'s "data" axis (all of them without one)."""
    n = axis_size(mesh, "data")
    if batch % n:
        raise ValueError(f"a batch of {batch} does not split over "
                         f"{n} data ranks")
    step = batch // n
    i = axis_rank(mesh, "data")
    return slice(i * step, (i + 1) * step)


def gather_rows(x: torch.Tensor, batch: int, mesh) -> torch.Tensor:
    """The global batch's rows from each data rank's ``x`` (its rows
    ``data_rows``): a zero-padded sum over the "data" axis."""
    n = axis_size(mesh, "data")
    if n == 1:
        return x
    full = x.new_zeros((batch, *x.shape[1:]))
    full[data_rows(batch, mesh)] = x
    return _all_reduce_(full, mesh.get_group("data"))
