# The paper's primary contribution: context-aware bifurcated attention and
# the generalized multi-group attention family it applies to.
from repro_torch.core.attention import decode_attention, multigroup_attention
from repro_torch.core.bifurcated import (
    bifurcated_attention,
    bifurcated_attention_flash,
    merge_partials,
)
from repro_torch.core.kv_cache import BifurcatedCache, DecodeCache, update_layer_cache
from repro_torch.core.policy import BifurcationPolicy

__all__ = [
    "multigroup_attention",
    "decode_attention",
    "bifurcated_attention",
    "bifurcated_attention_flash",
    "merge_partials",
    "DecodeCache",
    "BifurcatedCache",
    "update_layer_cache",
    "BifurcationPolicy",
]
