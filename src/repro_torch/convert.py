"""Carry parameters across from the JAX reference by name.

``params_from_numpy`` takes the reference's parameter tree with its leaves
as numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the
port's tree, the same names and shapes, on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device="cuda"):
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)
