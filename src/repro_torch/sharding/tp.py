"""Tensor parallelism over the mesh's "model" axis and parameter
sharding over its "data" axis (ZeRO-3): the reference's ``TP_RULES`` and
``FSDP_RULES`` split at every mesh size, with plain local shards and
explicit collectives.

The reference names a sharding and lets GSPMD partition the step.  Here
each rank holds plain tensors, its box of every parameter leaf
(``models.params.shard_params``: the boxes of
``NamedSharding(mesh, param_specs(...))``), and the model code calls the
collective that GSPMD would insert between a leaf's box and the layout
that the reference's ``constrain`` sites give an activation.  Whether a
leaf or an activation is split is read from its resolved spec
(``site_split``, ``split_axes``) or from its local width against the
config's (``is_split``, over "model" only), never from whether an axis
exists: a leaf the size does not divide stays whole, and its product runs
whole on every rank.

The "model" axis's collectives, each with its gradient (a whole
activation carries its whole gradient on every rank, a split one its
box's):

* ``enter(x)``: identity forward, all-reduce backward (Megatron's ``f``),
  on the whole input of a column-split product (q / k / v, gate / up, the
  LM head, RWKV-6's r / k / v / g), whose backward gives each rank a
  partial dx;
* ``reduce(x)``: all-reduce forward, identity backward (Megatron's
  ``g``), on the partial sums a rank holds: a row-split product's output
  (``o @ wo``, ``h @ w_down``), the vocab-split embedding, the
  cross-entropy's sums over vocab shards;
* ``gather(x, dim)``: a column box to the whole (a zero-padded
  all-reduce); its backward is the slice (the MoE layer's expert outputs
  at the reference's whole ``ye`` site);
* ``scatter(x, dim)``: the slice from the whole to the rank's box; its
  backward is the gather (Megatron's scatter / gather pair; the MoE
  layer's dispatch buffer at the ``act_experts`` site);
* ``reduce_scatter(x, dim)``: partial sums to the rank's box of their
  sum (an all-reduce, then the slice); its backward is the gather;
* ``all_max`` and ``argmax``: the max and the greedy argmax over vocab
  shards (the argmax takes the lowest index among equal maxima, as
  ``torch.argmax`` does).

The "data" axis splits parameters only under ``FSDP_RULES``, whose param
``embed`` axis goes over ("pod", "data"), "all-gathered per scanned
layer": ``gather_param(x, dim, dtype)`` casts a leaf's box to the
compute dtype (the same bits as casting after the gather, half the bytes
at bf16) and gathers its rows from the data ranks, one broadcast a rank;
its backward is the reduce-scatter, the data ranks' gradients summed in
the leaf's own dtype (an all-reduce) and cut to the rank's rows.  Such a
leaf's gradient is then the whole batch's already, and the train step's
all-reduce over "data" skips it.

Every collective is an ``all_reduce`` but the parameter gather's
broadcasts: gloo on CUDA tensors (several ranks on one card) offers
``all_reduce`` and ``broadcast`` only.  All are
the identity when the active mesh (``use_rules(mesh, rules)``) has no
such axis of more than one rank, so the one-process path is unchanged.

``check_model_axis`` raises for what is not split yet: the
encoder-decoder and the frames / patches frontends, the int8 cache,
rules other than ``TP_RULES`` and ``FSDP_RULES`` (``SEQ_RULES``), and an
RWKV-6 "rnn" split that would cut inside a head's recurrence (compressed
gradients raise in ``train.make_train_step``).
"""
from __future__ import annotations

import types
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from .rules import active_rules, mesh_shape, spec

AXIS = "model"
DATA = "data"


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


def mesh_axis(mesh, name: str = AXIS) -> Optional[ModelAxis]:
    """``mesh``'s axis ``name`` (default "model"), or None when it has
    none or one rank."""
    size = axis_size(mesh, name)
    if size == 1:
        return None
    return ModelAxis(mesh.get_group(name), size, axis_rank(mesh, name))


def model_axis() -> Optional[ModelAxis]:
    """The "model" axis of the active mesh (``use_rules``), or None."""
    pair = active_rules()
    return None if pair is None else mesh_axis(pair[0])


def data_axis() -> Optional[ModelAxis]:
    """The "data" axis of the active mesh (``use_rules``), or None."""
    pair = active_rules()
    return None if pair is None else mesh_axis(pair[0], DATA)


def check_model_axis(cfg, size: int, rules=None, data: int = 1) -> None:
    """Raise ``ValueError`` where ``cfg`` is not split over a ("data"
    ``data``, "model" ``size``) mesh: the encoder-decoder and the frames /
    patches frontends, the int8 KV cache, rules other than ``TP_RULES``
    and ``FSDP_RULES``, and an RWKV-6 model whose state width the size
    divides but whose heads it does not (the "rnn" split would cut inside
    a head's recurrence, and the reference's state is then whole).  Every
    other size runs: a leaf the size does not divide stays whole.  With
    one model rank it checks only under ``FSDP_RULES``, whose parameters
    the data ranks split."""
    from .rules import FSDP_RULES, TP_RULES

    if size == 1 and (data == 1 or rules != FSDP_RULES):
        return
    later = []
    if cfg.is_encdec or cfg.frontend != "token":
        later.append(f"the {cfg.frontend} frontend")
    if cfg.kv_quant:
        later.append("the int8 KV cache")
    if rules is not None and rules not in (TP_RULES, FSDP_RULES):
        later.append("rules other than TP_RULES and FSDP_RULES")
    if later:
        raise ValueError(f"{cfg.name}: a ('data' {data}, 'model' {size}) "
                         f"mesh is not split for {', '.join(later)}")
    if cfg.mixer == "rwkv6":
        heads = cfg.d_model // cfg.rwkv_head_dim
        if cfg.d_model % size == 0 and heads % size:
            raise ValueError(
                f"{cfg.name}: a 'model' axis of {size} splits the "
                f"{cfg.d_model}-wide 'rnn' axis inside its {heads} heads of "
                f"{cfg.rwkv_head_dim}: an RWKV-6 head's recurrence is not "
                f"split")


# --------------------------------------------------------------------------
# what is split
# --------------------------------------------------------------------------
def _model_spec(axes, dims, rules, size: int):
    """``axes`` of a tensor of ``dims`` resolved on a mesh of the "model"
    axis alone (no other axis competes with it for a dim)."""
    return spec(axes, rules, types.SimpleNamespace(shape={AXIS: size}), dims)


def on_axis(entry, axis: str = AXIS) -> bool:
    """Whether a ``PartitionSpec`` entry splits its dim over ``axis``
    (default "model")."""
    return axis in ((entry,) if isinstance(entry, str) else tuple(entry or ()))


def split_axes(pspec, mesh) -> tuple:
    """The axes of ``mesh`` (of more than one rank, in the mesh's order)
    that split a leaf whose resolved spec is ``pspec``: ("data",),
    ("model",), both, or none."""
    return tuple(a for a, n in mesh_shape(mesh).items()
                 if n > 1 and any(on_axis(e, a) for e in pspec))


def is_split(local: int, full: Optional[int]) -> bool:
    """Whether a dim of ``full`` entries held as ``local`` is split over
    the active "model" axis (a leaf the size does not divide is whole).
    Under a "model" axis the whole width must be given."""
    if model_axis() is None:
        return False
    if full is None:
        raise ValueError("under a 'model' axis a split is told from the "
                         "whole width: give it")
    return local != full


def site_split(axes: Sequence[Optional[str]], dims: Sequence[int],
               rules=None) -> bool:
    """Whether the active rules (or ``rules``) resolve an activation of
    whole shape ``dims`` with logical ``axes`` to a split over "model"
    (a ``constrain`` site's layout)."""
    pair = active_rules()
    ax = model_axis()
    if ax is None:
        return False
    return any(on_axis(a)
               for a in _model_spec(axes, dims, rules or pair[1], ax.size))


def local_shape(axes: Sequence[Optional[str]], dims: Sequence[int],
                rules, size: int) -> tuple:
    """The rank's box shape of a tensor of whole shape ``dims`` and
    logical ``axes`` on a "model" axis of ``size`` ranks (other mesh
    axes left out: a rank's rows of the batch are its own already)."""
    if size == 1:
        return tuple(dims)
    out = list(dims)
    for d, a in enumerate(_model_spec(axes, dims, rules, size)):
        if on_axis(a):
            out[d] //= size
    return tuple(out)


# --------------------------------------------------------------------------
# the collectives with their gradients
# --------------------------------------------------------------------------
def _all_reduce_(x: torch.Tensor, group, op=None) -> torch.Tensor:
    dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=group)
    return x


def _gather(x: torch.Tensor, dim: int, ax: ModelAxis) -> torch.Tensor:
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * ax.size
    full = x.new_zeros(shape)
    full.narrow(dim, ax.rank * n, n).copy_(x)
    return _all_reduce_(full, ax.group)


def _part(x: torch.Tensor, dim: int, ax: ModelAxis) -> torch.Tensor:
    n = x.shape[dim] // ax.size
    return x.narrow(dim, ax.rank * n, n).contiguous()


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


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _gather(x, dim, ax)

    @staticmethod
    def backward(ctx, dy):
        return _part(dy, ctx.dim, ctx.ax), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _part(x, dim, ax)

    @staticmethod
    def backward(ctx, dy):
        return _gather(dy.contiguous(), ctx.dim, ctx.ax), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _part(_all_reduce_(x.contiguous().clone(), ax.group), dim, ax)

    @staticmethod
    def backward(ctx, dy):
        return _gather(dy.contiguous(), ctx.dim, ctx.ax), None, None


def _broadcast_gather(x: torch.Tensor, dim: int, ax: ModelAxis
                      ) -> torch.Tensor:
    """The whole tensor from every rank's box of it along ``dim``: one
    broadcast a rank, each box sent once (a zero-padded all-reduce would
    move the whole tensor from every rank)."""
    x = x.contiguous()
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * ax.size
    full = x.new_empty(shape)
    for r in range(ax.size):
        box = x if r == ax.rank else torch.empty_like(x)
        dist.broadcast(box, src=dist.get_global_rank(ax.group, r),
                       group=ax.group)
        full.narrow(dim, r * n, n).copy_(box)
    return full


class _ParamGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax, dtype):
        ctx.dim, ctx.ax, ctx.dtype = dim, ax, x.dtype
        return _broadcast_gather(x.to(dtype), dim, ax)

    @staticmethod
    def backward(ctx, dy):
        dx = dy.contiguous().to(ctx.dtype, copy=True)
        return _part(_all_reduce_(dx, ctx.ax.group), ctx.dim, ctx.ax), \
            None, None, None


def _grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def enter(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-split product: x as it is, its gradient
    summed over the model ranks."""
    ax = model_axis()
    if ax is None or not _grad(x):
        return x
    return _Enter.apply(x, ax.group)


def reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum of every model rank's ``x`` (its gradient passed on as it
    is).  With no gradient to carry, ``x`` itself is summed in place:
    callers pass a fresh partial result."""
    ax = model_axis()
    if ax is None:
        return x
    if _grad(x):
        return _Reduce.apply(x, ax.group)
    return _all_reduce_(x if x.is_contiguous() else x.contiguous(), ax.group)


def gather(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The whole tensor from every model rank's box of it along ``dim``
    (boxes in rank order); the gradient is sliced back to the box."""
    ax = model_axis()
    if ax is None:
        return x
    dim = dim % x.dim()
    if _grad(x):
        return _Gather.apply(x, dim, ax)
    return _gather(x, dim, ax)


def scatter(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """This rank's box along ``dim`` of a whole ``x``; the gradient is
    gathered from every rank's, so the whole ``x`` gets its whole
    gradient."""
    ax = model_axis()
    if ax is None:
        return x
    dim = dim % x.dim()
    if _grad(x):
        return _Scatter.apply(x, dim, ax)
    return _part(x, dim, ax)


def reduce_scatter(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """This rank's box along ``dim`` of the sum of every model rank's
    ``x`` (partial sums); the gradient is the box's gathered."""
    ax = model_axis()
    if ax is None:
        return x
    dim = dim % x.dim()
    if _grad(x):
        return _ReduceScatter.apply(x, dim, ax)
    return _part(_all_reduce_(x.contiguous(), ax.group), dim, ax)


def gather_param(x: torch.Tensor, dim: int, dtype=None) -> torch.Tensor:
    """A parameter leaf whole from every data rank's box of it along
    ``dim`` (its rows under ``FSDP_RULES``), cast to ``dtype`` before the
    gather; its gradient is summed over the data ranks in ``x``'s dtype
    and cut to the box (the reduce-scatter).  ``x`` as it is without a
    "data" axis of more than one rank."""
    ax = data_axis()
    if ax is None:
        return x
    dtype = dtype or x.dtype
    dim = dim % x.dim()
    if _grad(x):
        return _ParamGather.apply(x, dim, ax, dtype)
    return _broadcast_gather(x.to(dtype), dim, ax)


def all_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over the model ranks of ``x`` (no gradient)."""
    ax = model_axis()
    x = x.detach()
    if ax is None:
        return x
    return _all_reduce_(x.contiguous().clone(), ax.group, dist.ReduceOp.MAX)


def vocab_offset(local: int, full: int) -> int:
    """The global index of this rank's first vocab row (``local`` of the
    padded vocab's ``full`` rows a rank, split in order over the model
    ranks; 0 when the vocab is whole)."""
    ax = model_axis()
    return ax.rank * local if is_split(local, full) else 0


def argmax(logits: torch.Tensor, full: int) -> torch.Tensor:
    """The greedy argmax over the last axis of ``logits``, vocab-split
    when they hold fewer than the padded vocab's ``full`` columns (global
    indices), the lowest index among equal maxima."""
    ax = model_axis()
    if not is_split(logits.shape[-1], full):
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
