"""qwen1.5-32b — dense GQA with QKV bias [hf:Qwen/Qwen1.5 family; hf].

Note: n_heads = n_kv_heads = 40 is not divisible by the 16-way model axis;
the config system pads heads to 48 when head_pad_multiple=16 is applied at
lowering (Megatron-style padding; waste shows up in §Roofline's
MODEL_FLOPS / HLO_FLOPs ratio as intended).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
)
