"""xlstm-1.3b — sLSTM + mLSTM blocks, attention-free [arXiv:2405.04517;
unverified]. 48 layers = 6 groups of (7 mLSTM + 1 sLSTM) (~7:1 ratio).

Bifurcated attention is inapplicable (no KV cache): the shared-prefix
analogue is broadcasting the post-prefill recurrent state to the samples.
d_ff=0: the mLSTM block carries its own 2x expansion."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="xlstm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    rope_theta=0.0,
    ssm=SSMConfig(kind="mlstm", expand=2, slstm_every=8, chunk=256),
)
