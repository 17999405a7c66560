"""Model registry: cfg.family -> model implementation.

Every model exposes:
  init(seed, device=, dtype=) -> params
  prefill(params, tokens) -> (logits, cache)
  decode_step(params, cache, tokens, impl=) -> (logits, cache)
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def get_model(cfg: ModelConfig):
    if cfg.family == "dense":
        from repro_torch.models.transformer import TransformerLM

        return TransformerLM(cfg)
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import HybridModel

        return HybridModel(cfg)
    if cfg.family == "xlstm":
        from repro_torch.models.xlstm import XLSTMModel

        return XLSTMModel(cfg)
    if cfg.family in ("moe", "vlm", "encdec"):
        raise NotImplementedError(f"model family {cfg.family!r} is not ported")
    raise ValueError(f"unknown model family: {cfg.family}")
