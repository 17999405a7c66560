# The paper's primary contribution: context-aware bifurcated attention and
# the generalized multi-group attention family it applies to.
from repro_torch.core.attention import decode_attention, multigroup_attention
from repro_torch.core.bifurcated import (
    bifurcated_attention,
    bifurcated_attention_flash,
    forest_bifurcated_attention,
    merge_partials,
)
from repro_torch.core.kv_cache import (
    BifurcatedCache,
    DecodeCache,
    GroupedBifurcatedCache,
    update_layer_cache,
)
from repro_torch.core.policy import BifurcationPolicy
from repro_torch.core.quantized import (
    GroupedQuantBifurcatedCache,
    QuantBifurcatedCache,
    bifurcated_attention_q8,
    ctx_cache_family,
    forest_bifurcated_attention_q8,
    forest_cache_family,
    quantize_ctx,
)

__all__ = [
    "multigroup_attention",
    "decode_attention",
    "bifurcated_attention",
    "bifurcated_attention_flash",
    "forest_bifurcated_attention",
    "merge_partials",
    "DecodeCache",
    "BifurcatedCache",
    "GroupedBifurcatedCache",
    "update_layer_cache",
    "BifurcationPolicy",
    "QuantBifurcatedCache",
    "GroupedQuantBifurcatedCache",
    "quantize_ctx",
    "bifurcated_attention_q8",
    "forest_bifurcated_attention_q8",
    "ctx_cache_family",
    "forest_cache_family",
]
