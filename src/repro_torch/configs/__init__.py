from repro_torch.configs.acar import (
    ACAR_U, ACAR_UJ, ACAR_UJ_ALIGNED, ACARConfig)
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCH_IDS, all_configs, get_config

__all__ = [
    "ACARConfig", "ACAR_U", "ACAR_UJ", "ACAR_UJ_ALIGNED", "ARCH_IDS",
    "ModelConfig", "all_configs", "get_config",
]
