"""mixtral-8x7b — 8 experts top-2, GQA kv=8, sliding-window attention
[arXiv:2401.04088; hf]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    sliding_window=4096,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25, group_size=512),
)
