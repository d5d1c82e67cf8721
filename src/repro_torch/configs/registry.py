"""Architecture registry: ``--arch <id>`` -> ModelConfig.

Only the architectures the port runs are listed (the dense family
serves and trains; the ssm and hybrid families train); the rest of the
zoo joins as its model families are ported.
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
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
