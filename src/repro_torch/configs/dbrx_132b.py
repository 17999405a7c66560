"""dbrx-132b — fine-grained MoE, 16 experts top-4, GQA kv=8
[hf:databricks/dbrx-base; unverified]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    act="swiglu",
    norm="layernorm",
    rope_theta=500_000.0,
    moe=MoEConfig(n_experts=16, top_k=4, capacity_factor=1.25, group_size=512),
)
