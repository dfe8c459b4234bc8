"""Carry parameters and train states across from the JAX reference by
name.

``params_from_numpy`` takes the reference's parameter tree with its leaves
as numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the
port's tree, the same names and shapes, on ``device`` (with a ``cfg`` and
a ``mesh``, only this rank's shards: ``models.shard_params``);
``train_state_from_numpy`` does the same for a whole ``TrainState``.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device="cuda", cfg=None, mesh=None):
    if mesh is not None:
        from .models import shard_params

        tree = shard_params(tree, cfg, mesh, copy=False)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def train_state_from_numpy(state, device="cuda"):
    """The reference's ``TrainState`` with numpy leaves
    (``jax.tree.map(np.asarray, state)``: params, opt.mu / nu / count /
    err, step) as the port's ``TrainState`` on ``device``."""
    from .optim import AdamWState
    from .train.state import TrainState

    opt = state.opt
    return TrainState(
        params=params_from_numpy(state.params, device),
        opt=AdamWState(mu=params_from_numpy(opt.mu, device),
                       nu=params_from_numpy(opt.nu, device),
                       count=params_from_numpy(opt.count, device),
                       err=None if opt.err is None
                       else params_from_numpy(opt.err, device)),
        step=params_from_numpy(state.step, device))
