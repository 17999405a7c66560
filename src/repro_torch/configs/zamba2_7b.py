"""zamba2-7b — Mamba2 backbone + one globally-shared attention block
[arXiv:2411.15242; unverified]. 81 mamba layers = 13 x 6 + 3 trailing;
shared attention+MLP applied after each group of 6 (weights shared)."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    attn_period=6,
    ssm=SSMConfig(kind="mamba2", state_dim=64, head_dim=64, expand=2, chunk=256),
)
