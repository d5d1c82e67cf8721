"""Architecture registry: ``--arch <id>`` -> ModelConfig.

Only the architectures the port runs are listed: the dense, ssm,
hybrid and MoE families (MoE with GQA or MLA attention), which serve
and train. The audio and vision configs join as their model families
are ported.
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "granite-34b": "repro_torch.configs.granite_34b",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
}

ARCH_IDS: Tuple[str, ...] = tuple(_ARCH_MODULES)


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {arch!r}; available: {', '.join(ARCH_IDS)}")
    mod = importlib.import_module(_ARCH_MODULES[arch])
    return mod.REDUCED if reduced else mod.CONFIG


def all_configs(reduced: bool = False) -> Dict[str, ModelConfig]:
    return {a: get_config(a, reduced) for a in ARCH_IDS}
