"""Task records served by the engine.

Only the ``Task`` record is ported so far; the synthetic suites of the
reference (``paper_suite``, ``arithmetic_suite``) join with the
benchmarks that use them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class Task:
    task_id: str
    benchmark: str
    kind: str                  # math | reasoning | code | mcq
    text: str
    gold: str
    difficulty: float          # latent, synthetic-backend only
    wrong_pool: Tuple[str, ...] = ()
    wrong_weights: Tuple[float, ...] = ()
