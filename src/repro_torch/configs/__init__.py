from repro_torch.configs.base import (
    ForestConfig,
    ModelConfig,
    MoEConfig,
    ServeConfig,
    SSMConfig,
    TreeConfig,
)
from repro_torch.configs.registry import ARCH_IDS, get_config, reduced_config

__all__ = [
    "ForestConfig", "ModelConfig", "MoEConfig", "ServeConfig", "SSMConfig", "TreeConfig", "ARCH_IDS", "get_config", "reduced_config",
]
