"""Architecture registry: ``--arch <id>`` -> ModelConfig.

The reference's ten architectures in its order: the dense, ssm,
hybrid, MoE (GQA or MLA attention), audio (whisper's encoder-decoder)
and vision (a patch-embedding prefix) families, each of which serves
and trains.
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "granite-34b": "repro_torch.configs.granite_34b",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
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
