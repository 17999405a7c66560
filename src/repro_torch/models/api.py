"""Model registry: cfg.family -> model implementation.

Every model exposes:
  init(seed, device=, dtype=) -> params
  prefill(params, tokens) -> (logits, cache)
  decode_step(params, cache, tokens, impl=) -> (logits, cache)
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def get_model(cfg: ModelConfig):
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models.transformer import TransformerLM

        return TransformerLM(cfg)
    if cfg.family == "encdec":
        from repro_torch.models.encdec import EncDecModel

        return EncDecModel(cfg)
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import HybridModel

        return HybridModel(cfg)
    if cfg.family == "xlstm":
        from repro_torch.models.xlstm import XLSTMModel

        return XLSTMModel(cfg)
    raise ValueError(f"unknown model family: {cfg.family}")
