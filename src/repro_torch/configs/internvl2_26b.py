"""internvl2-26b — InternViT (stub frontend) + InternLM2-20B language
backbone [arXiv:2404.16821; hf]. input_specs() provides 1024 precomputed
patch embeddings; image tokens join the shared prefix and are covered by
bifurcated attention identically to text context."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    n_image_tokens=1024,
)
