"""Attention masks as additive bias.

Masks are boolean with True = attend; they are converted to additive bias
(0 / NEG_INF) at the softmax site, in float32.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def mask_to_bias(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    zero = torch.zeros((), dtype=dtype, device=mask.device)
    return torch.where(mask, zero, torch.full((), NEG_INF, dtype=dtype,
                                              device=mask.device))
