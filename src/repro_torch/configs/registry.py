"""Architecture registry: ``--arch <id>`` -> ModelConfig, plus reduced
smoke-test variants and the paper's own model configs (Table 1/4)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

_ARCH_MODULES = {
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "qwen1.5-32b": "repro_torch.configs.qwen1_5_32b",
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
}

ARCH_IDS = tuple(_ARCH_MODULES)

# ---- the paper's own experiment models ----

# Table 1 / §5.3: 7B multi-head (32L, d=4096, 32 heads).
PAPER_7B_MH = ModelConfig(
    name="paper-7b-mh", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=32, d_ff=16384, vocab_size=51200, act="gelu",
    rope_theta=10_000.0,
)
# Table 7: same 7B with 8 kv heads (GQA).
PAPER_7B_GQA = dataclasses.replace(PAPER_7B_MH, name="paper-7b-gqa", n_kv_heads=8)
# Table 4: ~1B capability-equalized trio for the MH-vs-MQ latency study.
PAPER_1B_MH = ModelConfig(
    name="paper-1b-mh", family="dense", n_layers=12, d_model=2560,
    n_heads=20, n_kv_heads=20, head_dim=128, d_ff=10240, vocab_size=51200,
    act="gelu", rope_theta=10_000.0,
)
PAPER_1B_MG = ModelConfig(
    name="paper-1b-mg", family="dense", n_layers=15, d_model=2560,
    n_heads=20, n_kv_heads=4, head_dim=128, d_ff=10240, vocab_size=51200,
    act="gelu", rope_theta=10_000.0,
)
PAPER_1B_MQ = ModelConfig(
    name="paper-1b-mq", family="dense", n_layers=16, d_model=2560,
    n_heads=20, n_kv_heads=1, head_dim=128, d_ff=10240, vocab_size=51200,
    act="gelu", rope_theta=10_000.0,
)

_PAPER = {c.name: c for c in
          (PAPER_7B_MH, PAPER_7B_GQA, PAPER_1B_MH, PAPER_1B_MG, PAPER_1B_MQ)}


def get_config(arch: str) -> ModelConfig:
    if arch in _PAPER:
        return _PAPER[arch]
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port serves "
                       f"{ARCH_IDS + tuple(_PAPER)}")
    import importlib

    mod = importlib.import_module(_ARCH_MODULES[arch])
    return mod.CONFIG


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Shrink a full config to a CPU-smoke-test size, same family/topology."""
    h = 4
    kv = max(1, min(cfg.n_kv_heads, h // max(1, cfg.n_heads // cfg.n_kv_heads)))
    kw = dict(
        d_model=64,
        n_heads=h,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=512,
        vocab_pad_multiple=16,
        head_pad_multiple=1,
        decode_capacity=16,
    )
    if cfg.family == "xlstm":
        kw.update(n_layers=4, n_heads=2, n_kv_heads=2,
                  ssm=dataclasses.replace(cfg.ssm, slstm_every=2, chunk=16))
    elif cfg.family == "hybrid":
        kw.update(n_layers=5, attn_period=2,
                  ssm=dataclasses.replace(cfg.ssm, state_dim=8, head_dim=8, chunk=16))
    elif cfg.family == "encdec":
        kw.update(n_layers=2, n_encoder_layers=2, max_position=128,
                  max_enc_position=128)
    elif cfg.family == "vlm":
        kw.update(n_layers=2, n_image_tokens=8)
    else:
        kw.update(n_layers=2)
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            n_experts=4, top_k=min(cfg.moe.top_k, 2), capacity_factor=2.0,
            group_size=16,
        )
    if cfg.sliding_window:
        kw["sliding_window"] = 8
    return dataclasses.replace(cfg, **kw)
