"""Weights from the JAX reference's parameter tree, and the weight-dtype rule.

``params_from_numpy`` takes the reference's param pytree (the dict that
``repro.models.TransformerLM.init`` returns, layers stacked under
``params["layers"]`` with a leading L axis, or ``repro.models.HybridModel
.init``'s, Mamba2 layers stacked under ``params["mamba"]`` /
``["mamba_tail"]``, or ``repro.models.XLSTMModel.init``'s, mLSTM layers
stacked (groups, per group) under ``params["mlstm"]``, sLSTM layers under
``params["slstm"]``) with every leaf given as a numpy array, and returns
the same tree of torch tensors, which the port's model takes as its
weights.
This module imports no jax: the caller hands it numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device

# Leaves the reference applies in float32, kept so: the norm params
# (blocks.apply_norm, rms_normalize: ln1, ln2, final_norm, the Mamba2 and
# xLSTM "ln" and "norm_scale"), the Mamba2 leaves its float32 arithmetic
# reads (A_log, dt_bias, the conv's conv_w and conv_b; models/mamba.py) and
# the xLSTM gates' (the mLSTM's w_gates and gate_bias, the sLSTM's r_rec
# and bias; models/xlstm.py), the MoE router (routing is fp32: a bf16
# router flips top-k choices; models/moe.py) and the encoder-decoder's
# norms (ln_x, enc_norm). "bias" is also a layernorm leaf, which sits under
# ln1 / ln2 / final_norm and is kept anyway. The position tables of the
# encoder-decoder are cast to the activation dtype at each use in the
# reference, so they are cast at load with the matmul weights.
FP32_KEYS = ("ln1", "ln2", "final_norm", "ln", "norm_scale", "A_log",
             "dt_bias", "conv_w", "conv_b", "w_gates", "gate_bias", "r_rec",
             "bias", "router", "ln_x", "enc_norm")


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: torch.from_numpy rejects it
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def cast_weights(tree, dtype, _keep: bool = False):
    """Cast every floating leaf outside ``FP32_KEYS`` to ``dtype``: the
    reference casts each matmul weight to the activation dtype at every
    use; casting once at load gives the same bits."""
    if isinstance(tree, dict):
        return {k: cast_weights(v, dtype, _keep or k in FP32_KEYS)
                for k, v in tree.items()}
    if _keep or dtype is None or not tree.is_floating_point():
        return tree
    return tree.to(dtype)


def params_from_numpy(tree, *, device="cuda", dtype=torch.bfloat16):
    """The reference's param tree (numpy leaves) as the port's weights on
    ``device``; matmul weights cast to ``dtype`` (None keeps each leaf's
    dtype), the ``FP32_KEYS`` leaves kept as given."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return _to_tensor(t).to(dev)

    return cast_weights(conv(tree), dtype)
