"""Parameter accounting and sharding-spec resolution for whole param
trees, the twin of ``repro/models/params.py``.

An axes tree mirrors a param (or cache, or state) tree, with a tuple of
logical axis names (``str`` or None) at each leaf; ``map_axes`` walks one
with any trees of the same structure beside it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..configs.base import ModelConfig
from ..sharding import NamedSharding, Rules
from ..sharding import spec as axes_spec

_EXPERT_KEYS = ("w_gu", "w_down")


def tree_paths(tree, path=()):
    """(keys from the root, leaf) for every leaf of a tree of dicts, in
    its order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, path + (k,))
    else:
        yield path, tree


def tree_at(tree, path):
    """The subtree of a tree of dicts at ``path`` (keys from the root)."""
    for k in path:
        tree = tree[k]
    return tree


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
    for path, leaf in tree_paths(init_params(cfg, None, "meta")):
        n = leaf.numel()
        if active_only and cfg.num_experts and "moe" in path and any(
                k in _EXPERT_KEYS for k in path):
            n = int(n * frac)
        total += n
    return total


def is_axes(x) -> bool:
    """A leaf of an axes tree: a tuple of logical names (or None)."""
    return (isinstance(x, tuple) and not hasattr(x, "_fields")
            and all(e is None or isinstance(e, str) for e in x))


def map_axes(fn, axes, *trees):
    """``fn(axes leaf, matching leaves of trees...)`` over an axes tree of
    dicts, NamedTuples and lists, keeping its structure (None stays
    None)."""
    if axes is None:
        return None
    if is_axes(axes):
        return fn(axes, *trees)
    if isinstance(axes, dict):
        return {k: map_axes(fn, v, *(t[k] for t in trees))
                for k, v in axes.items()}
    if hasattr(axes, "_fields"):
        return type(axes)(*(map_axes(fn, v, *(getattr(t, f) for t in trees))
                            for f, v in zip(axes._fields, axes)))
    if isinstance(axes, list):
        return [map_axes(fn, v, *(t[i] for t in trees))
                for i, v in enumerate(axes)]
    raise TypeError(f"not an axes tree node: {axes!r}")


def param_specs(axes_tree, rules: Rules, mesh=None, shapes=None):
    """axes tree (+ an optional matching tree of tensors or anything with
    a ``shape``, e.g. ``abstract_params``' meta tensors) -> a tree of
    ``PartitionSpec``s (``repro/models/params.py:40-48``)."""
    if shapes is None:
        return map_axes(lambda ax: axes_spec(ax, rules), axes_tree)
    return map_axes(lambda ax, sh: axes_spec(ax, rules, mesh, sh.shape),
                    axes_tree, shapes)


def param_shardings(axes_tree, rules: Rules, mesh, shapes=None):
    """The ``NamedSharding`` tree of ``param_specs`` on ``mesh``."""
    specs = param_specs(axes_tree, rules, mesh, shapes)
    return map_axes(lambda ax, s: NamedSharding(mesh, s), axes_tree, specs)


def local_box(sharding: NamedSharding, shape, rank: Optional[int] = None):
    """``rank``'s box (one slice a dim) of an array of ``shape`` under
    ``sharding`` (default: this process's rank)."""
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return sharding.devices_indices_map(tuple(shape))[rank]


def _take(leaf, box, copy: bool):
    """``leaf[box]``: numpy or a tensor; with ``copy`` a tensor of its
    own (a view would keep the whole leaf alive) unless the box is the
    whole leaf."""
    part = leaf[box]
    whole = all(sl.stop - sl.start == n for sl, n in zip(box, leaf.shape))
    if not copy or whole:
        return part
    if isinstance(part, torch.Tensor):
        return part.clone(memory_format=torch.contiguous_format)
    return np.array(part, copy=True)


def param_split(cfg: ModelConfig, mesh, rules: Optional[Rules] = None):
    """A tree of the params' layout: the mesh axes of more than one rank
    that split each leaf (``sharding.tp.split_axes`` of its resolved
    spec): ("data",), ("model",), both, or () for a whole leaf.  ``mesh``
    may be a stand-in with a ``shape`` mapping."""
    from ..sharding import get_rules, tp
    from .transformer import abstract_params

    rules = rules or get_rules(cfg.rules)
    shapes, axes = abstract_params(cfg)
    specs = param_specs(axes, rules, mesh, shapes)
    return map_axes(lambda ax, s: tp.split_axes(s, mesh), axes, specs)


def shard_params(params, cfg: ModelConfig, mesh, rules: Optional[Rules] = None,
                 copy: bool = True):
    """This rank's box of every leaf of a whole parameter tree (numpy
    arrays or tensors, the reference's names and shapes) on ``mesh``:
    the box ``NamedSharding(mesh, param_specs(...))`` gives it, so the
    split is the reference's (``TP_RULES``: wq / bq on heads, wkv / bkv on
    kv heads, wo's rows, w_gu's columns, w_down's rows, the embedding's
    rows and the LM head's columns on the padded vocab, RWKV-6's and the
    RG-LRU's "rnn" leaves on their state width; norm scales whole).  The
    reference tests divisibility on a leaf's flattened width, so a box
    may end inside a head: yi-6b's ``wkv`` (512 columns, 4 kv heads of
    128) at "model" 8 gives each rank 64 columns, half a head;
    recurrentgemma-9b's one kv head splits at every size; RWKV-6's ``u``,
    ``gn_scale`` and ``gn_bias`` (H, head_dim) split over head_dim.  A
    leaf whose width the size does not divide is whole on every rank.
    Under ``FSDP_RULES`` every leaf with an ``"embed"`` axis (norm scales,
    the router, wq / wkv / wo, w_gu / w_down, dense and expert, the
    embedding table and the LM head) has its rows on that axis split over
    "data" as well, where the data ranks divide d_model: tiny dbrx-132b's
    ``w_gu`` (2, 2, 4, 64, 96) is a box of (2, 2, 2, 32, 96) on a (2, 2)
    mesh, its embedding (256, 64) one of (128, 32); the model gathers
    them at their use (``tp.gather_param``).
    ``copy=False`` returns views (a whole leaf is returned as it is
    either way).  Raises ``ValueError`` where ``cfg`` does not split over
    the mesh (``sharding.tp.check_model_axis``)."""
    from ..sharding import get_rules, tp
    from .transformer import param_axes

    rules = rules or get_rules(cfg.rules)
    tp.check_model_axis(cfg, tp.axis_size(mesh), rules,
                        tp.axis_size(mesh, "data"))
    axes = param_axes(cfg)
    specs = param_specs(axes, rules, mesh, params)
    return map_axes(lambda ax, s, leaf: _take(
        leaf, local_box(NamedSharding(mesh, s), leaf.shape), copy),
        axes, specs, params)
