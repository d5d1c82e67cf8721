"""ACAR orchestration configuration (paper §3.2, §4).

The paper's deployment uses Gemini 2.0 Flash as the probe and
{Claude Sonnet 4, GPT-4o, Gemini 2.0 Flash} as the ensemble. In this
framework the ensemble members are architectures from the zoo; the
default mirrors the paper's "one fast probe + three diverse members"
shape with smollm-135m as the fast probe.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ACARConfig:
    n_probe_samples: int = 3                  # paper: N=3
    probe_temperature: float = 0.7            # probe sampling temperature
    ensemble_temperature: float = 0.0         # paper: temperature 0
    probe_model: str = "smollm-135m"
    ensemble_models: Tuple[str, ...] = (
        "llama3-8b", "deepseek-7b", "mixtral-8x22b")
    # retrieval (ACAR-UJ / "Jungler")
    retrieval_enabled: bool = False
    retrieval_threshold: float = 0.0          # paper's (bad) default
    retrieval_top_k: int = 1
    # arena_lite uses the first two ensemble members (paper: Claude+GPT-4o)
    arena_lite_size: int = 2
    seed: int = 0


ACAR_U = ACARConfig()
ACAR_UJ = ACARConfig(retrieval_enabled=True, retrieval_threshold=0.0)
# the paper's §6.1 recommendation
ACAR_UJ_ALIGNED = ACARConfig(retrieval_enabled=True, retrieval_threshold=0.7)
