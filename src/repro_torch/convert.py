"""Weights from the JAX reference's parameter tree, and the weight-dtype rule.

``params_from_numpy`` takes the reference's param pytree (the dict that
``repro.models.TransformerLM.init`` returns, layers stacked under
``params["layers"]`` with a leading L axis) with every leaf given as a numpy
array, and returns the same tree of torch tensors, which the port's
``TransformerLM`` takes as its weights. This module imports no jax: the
caller hands it numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device

# Norm params are applied in float32 (models/blocks.apply_norm) and stay so.
NORM_KEYS = ("ln1", "ln2", "final_norm")


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: torch.from_numpy rejects it
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def cast_weights(tree, dtype, _in_norm: bool = False):
    """Cast every floating leaf outside ``NORM_KEYS`` to ``dtype``: the
    reference casts each matmul weight to the activation dtype at every
    use; casting once at load gives the same bits."""
    if isinstance(tree, dict):
        return {k: cast_weights(v, dtype, _in_norm or k in NORM_KEYS)
                for k, v in tree.items()}
    if _in_norm or dtype is None or not tree.is_floating_point():
        return tree
    return tree.to(dtype)


def params_from_numpy(tree, *, device="cuda", dtype=torch.bfloat16):
    """The reference's param tree (numpy leaves) as the port's weights on
    ``device``; matmul weights cast to ``dtype`` (None keeps each leaf's
    dtype), norm params kept as given."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return _to_tensor(t).to(dev)

    return cast_weights(conv(tree), dtype)
