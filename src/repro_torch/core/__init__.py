# The paper's primary contribution: context-aware bifurcated attention and
# the generalized multi-group attention family it applies to.
from repro_torch.core.attention import decode_attention, multigroup_attention
from repro_torch.core.bifurcated import (
    bifurcated_attention,
    bifurcated_attention_flash,
    forest_bifurcated_attention,
    merge_partials,
    tree_bifurcated_attention,
)
from repro_torch.core.kv_cache import (
    BifurcatedCache,
    DecodeCache,
    GroupedBifurcatedCache,
    PrefixTreeCache,
    update_layer_cache,
)
from repro_torch.core.paged import (
    PAGED_CACHE_FAMILIES,
    PageAllocator,
    PagedBifurcatedCache,
    PagedGroupedBifurcatedCache,
    PagedKVStore,
    PagedPrefixTreeCache,
    QuantPagedKVStore,
    gather_pages,
    paged_store_family,
    pages_needed,
)
from repro_torch.core.policy import BifurcationPolicy
from repro_torch.core.quantized import (
    GroupedQuantBifurcatedCache,
    QuantBifurcatedCache,
    QuantPrefixTreeCache,
    bifurcated_attention_q8,
    ctx_cache_family,
    forest_bifurcated_attention_q8,
    forest_cache_family,
    quantize_ctx,
    tree_bifurcated_attention_q8,
    tree_cache_family,
)

__all__ = [
    "multigroup_attention",
    "decode_attention",
    "bifurcated_attention",
    "bifurcated_attention_flash",
    "forest_bifurcated_attention",
    "tree_bifurcated_attention",
    "merge_partials",
    "DecodeCache",
    "BifurcatedCache",
    "GroupedBifurcatedCache",
    "PrefixTreeCache",
    "update_layer_cache",
    "BifurcationPolicy",
    "QuantBifurcatedCache",
    "GroupedQuantBifurcatedCache",
    "QuantPrefixTreeCache",
    "quantize_ctx",
    "bifurcated_attention_q8",
    "forest_bifurcated_attention_q8",
    "ctx_cache_family",
    "forest_cache_family",
    "tree_bifurcated_attention_q8",
    "tree_cache_family",
    "PagedKVStore",
    "QuantPagedKVStore",
    "PageAllocator",
    "PagedBifurcatedCache",
    "PagedGroupedBifurcatedCache",
    "PagedPrefixTreeCache",
    "PAGED_CACHE_FAMILIES",
    "gather_pages",
    "pages_needed",
    "paged_store_family",
]
