"""Abstract inputs and shardings of every (arch x shape) cell, the twin of
``repro/launch/specs.py``.

``input_specs(cfg, shape)`` returns the inputs of the cell's step
(``train_step`` / ``prefill`` / ``decode_step``) as tensors on the ``meta``
device: shapes and dtypes, nothing allocated.  ``cell_shardings`` resolves
the matching ``NamedSharding``s on a mesh; ``spec`` reads only the mesh's
``shape``, so a stand-in of the production mesh (``mesh.production_mesh``)
resolves on one process.  The report (``report.py``) reads both.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models import abstract_params, cache_axes, init_cache, map_axes
from ..models import param_specs
from ..optim import AdamWConfig
from ..sharding import NamedSharding, Rules, get_rules, spec as axes_spec
from ..sharding import tp
from ..sharding.rules import mesh_shape
from ..train import abstract_train_state, train_state_specs


# --------------------------------------------------------------------------
# rules adjustment per cell
# --------------------------------------------------------------------------
def cell_rules(cfg: ModelConfig, shape: ShapeConfig, mesh,
               base: Optional[Rules] = None) -> Rules:
    """The config's rules; for serving, when the KV heads do not divide the
    "model" axis, the KV cache's sequence axis is split over "model"
    instead (``repro/launch/specs.py:28-38``)."""
    rules = base or get_rules(cfg.rules)
    if shape.kind in ("prefill", "decode"):
        model = mesh_shape(mesh).get("model", 1)
        if cfg.num_kv_heads % model != 0:
            rules = tp.kv_seq_rules(rules)
    return rules


def default_microbatches(cfg: ModelConfig, shape: ShapeConfig,
                         mesh) -> int:
    """Gradient-accumulation factor of a training cell: the sequences
    each data-parallel device holds (global batch over the "pod" x "data"
    devices), at most 8; 1 for serving (``repro/launch/specs.py:41-50``)."""
    if shape.kind != "train":
        return 1
    sizes = mesh_shape(mesh)
    data = sizes.get("data", 1) * sizes.get("pod", 1)
    per_dev = max(shape.global_batch // data, 1)
    return min(8, per_dev)


# --------------------------------------------------------------------------
# abstract inputs
# --------------------------------------------------------------------------
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_specs(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, Any]:
    out = {"tokens": _meta((batch, seq), torch.int32),
           "labels": _meta((batch, seq), torch.int32)}
    if cfg.frontend == "frames":
        out["frames"] = _meta((batch, cfg.num_frames, cfg.d_model),
                              torch.float32)
    if cfg.frontend == "patches":
        out["patches"] = _meta((batch, cfg.num_patches, cfg.d_model),
                               torch.float32)
    return out


def _serving_dtype(params, cfg: ModelConfig):
    """Serving weights in the compute dtype: every floating leaf cast, as
    the reference's ``_serving_dtype`` does (``specs.py:75-84``)."""
    dt = getattr(torch, cfg.dtype)

    def cast(t):
        if isinstance(t, dict):
            return {k: cast(v) for k, v in t.items()}
        return _meta(t.shape, dt) if t.is_floating_point() else t

    return cast(params)


def prefill_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """A prefill cache holds the patches before the prompt."""
    return shape.seq_len + (cfg.num_patches if cfg.frontend == "patches"
                            else 0)


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                opt_cfg: Optional[AdamWConfig] = None) -> Tuple[Any, ...]:
    """``meta`` inputs of the cell's step:

      train:   (TrainState, batch)
      prefill: (params, batch, cache)
      decode:  (params, cache, tokens)
    """
    if shape.kind == "train":
        state, _ = abstract_train_state(cfg, opt_cfg)
        return state, _batch_specs(cfg, shape.global_batch, shape.seq_len)
    params = _serving_dtype(abstract_params(cfg)[0], cfg)
    if shape.kind == "prefill":
        batch = _batch_specs(cfg, shape.global_batch, shape.seq_len)
        batch.pop("labels")
        cache = init_cache(cfg, shape.global_batch, prefill_len(cfg, shape),
                           device="meta")
        return params, batch, cache
    # decode: a cache of seq_len tokens, one new token
    cache = init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
    return params, cache, _meta((shape.global_batch, 1), torch.int32)


# --------------------------------------------------------------------------
# shardings
# --------------------------------------------------------------------------
def _tree_shardings(axes_tree, shapes_tree, rules: Rules, mesh):
    return map_axes(lambda ax, t: NamedSharding(
        mesh, axes_spec(ax, rules, mesh, t.shape)), axes_tree, shapes_tree)


def batch_shardings(batch_specs: Dict[str, Any], mesh, rules: Rules):
    """Each batch leaf split on its leading (batch) axis."""
    return {k: NamedSharding(mesh, axes_spec(
        ["batch"] + [None] * (t.dim() - 1), rules, mesh, t.shape))
        for k, t in batch_specs.items()}


def cell_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                   rules: Optional[Rules] = None,
                   opt_cfg: Optional[AdamWConfig] = None) -> Tuple[Any, ...]:
    """``NamedSharding``s matching ``input_specs`` leaf for leaf
    (``repro/launch/specs.py:120-170``)."""
    rules = rules or cell_rules(cfg, shape, mesh)
    if shape.kind == "train":
        state, state_axes = abstract_train_state(cfg, opt_cfg)
        sspecs = train_state_specs(cfg, mesh, state, state_axes, rules)
        state_sh = map_axes(lambda ax, s: NamedSharding(mesh, s),
                            state_axes, sspecs)
        batch = _batch_specs(cfg, shape.global_batch, shape.seq_len)
        return state_sh, batch_shardings(batch, mesh, rules)

    params, axes = abstract_params(cfg)
    p_sh = map_axes(lambda ax, s: NamedSharding(mesh, s), axes,
                    param_specs(axes, rules, mesh, params))
    c_axes = cache_axes(cfg)
    if shape.kind == "prefill":
        batch = _batch_specs(cfg, shape.global_batch, shape.seq_len)
        batch.pop("labels")
        cache = init_cache(cfg, shape.global_batch, prefill_len(cfg, shape),
                           device="meta")
        return (p_sh, batch_shardings(batch, mesh, rules),
                _tree_shardings(c_axes, cache, rules, mesh))
    cache = init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
    tok_sh = NamedSharding(mesh, axes_spec(
        ["batch", None], rules, mesh, (shape.global_batch, 1)))
    return p_sh, _tree_shardings(c_axes, cache, rules, mesh), tok_sh
