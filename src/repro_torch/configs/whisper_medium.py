"""whisper-medium — encoder-decoder audio backbone [arXiv:2212.04356;
unverified]. 24 encoder + 24 decoder layers (whisper counts per stack);
conv frontend is a stub: input_specs() provides precomputed frame
embeddings. Learned absolute positions (rope_theta = 0)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,
    n_encoder_layers=24,
    cross_attention=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    act="gelu",
    norm="layernorm",
    rope_theta=0.0,
    max_position=36_864,
    max_enc_position=32_768,
)
