"""Deterministic-execution capture (paper §3.1 invariant 1).

Every run records: random seed, prompt template hash, rubric version,
model identifiers, and an environment fingerprint. Re-execution with
identical inputs produces identical trace hashes.

The environment fingerprint names the framework that ran the models:
here PyTorch and the CUDA toolkit it was built for, where the JAX
package names its jax version. Its digest therefore differs between
the two packages by design; no record hash depends on it.
"""
from __future__ import annotations

import hashlib
import platform
import sys
from dataclasses import asdict, dataclass
from typing import Dict, Tuple

RUBRIC_VERSION = "acar-rubric-1.0"
PROMPT_TEMPLATE = (
    "Task: {task}\n"
    "Answer with the final result only.\n")
PROMPT_TEMPLATE_RETRIEVAL = (
    "Similar past example:\n{exemplar}\n\n"
    "Task: {task}\n"
    "Answer with the final result only.\n")


def prompt_hash(template: str) -> str:
    return hashlib.sha256(template.encode()).hexdigest()[:16]


def stable_fingerprint(text: str, bits: int = 31) -> int:
    """Process-stable non-negative integer fingerprint of a string.

    Python's builtin ``hash`` is salted per process (PYTHONHASHSEED),
    so PRNG keys derived from it differ between otherwise identical
    runs — exactly the nondeterminism the §3.1 invariant forbids. This
    sha256-derived value is identical everywhere."""
    h = hashlib.sha256(text.encode()).digest()
    return int.from_bytes(h[:8], "little") % (1 << bits)


@dataclass(frozen=True)
class EnvironmentFingerprint:
    python: str
    platform: str
    torch_version: str
    cuda_version: str
    rubric_version: str
    prompt_template_hash: str

    def digest(self) -> str:
        payload = "|".join(
            f"{k}={v}" for k, v in sorted(asdict(self).items()))
        return hashlib.sha256(payload.encode()).hexdigest()[:16]


def capture_environment() -> EnvironmentFingerprint:
    """The running environment: ``torch.__version__`` and
    ``torch.version.cuda`` (``"none"`` for a CPU-only build) stand in
    the reference's jax version field."""
    import torch
    return EnvironmentFingerprint(
        python=sys.version.split()[0],
        platform=platform.platform(),
        torch_version=torch.__version__,
        cuda_version=str(torch.version.cuda or "none"),
        rubric_version=RUBRIC_VERSION,
        prompt_template_hash=prompt_hash(PROMPT_TEMPLATE),
    )


def render_prompt(task_text: str, exemplar: str = "") -> str:
    if exemplar:
        return PROMPT_TEMPLATE_RETRIEVAL.format(
            exemplar=exemplar, task=task_text)
    return PROMPT_TEMPLATE.format(task=task_text)
