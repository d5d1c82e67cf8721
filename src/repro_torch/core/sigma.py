"""Self-consistency variance (paper Def. 1).

    sigma = (|{a_1, ..., a_N}| - 1) / (N - 1)   in {0, 0.5, 1} for N=3.

Two implementations: a host-side one over canonical answer strings, and
a vectorised torch one over batches of answer ids — the serving runtime
routes whole request batches with the latter. The batched functions
run on whatever device their input tensor lies on.
"""
from __future__ import annotations

from typing import Sequence

import torch


def sigma(answers: Sequence[str]) -> float:
    """Host-side sigma over extracted canonical answers."""
    n = len(answers)
    if n < 2:
        return 0.0
    distinct = len(set(answers))
    return (distinct - 1) / (n - 1)


def sigma_batch(answer_ids: torch.Tensor) -> torch.Tensor:
    """Vectorised sigma over answer ids.

    answer_ids: (B, N) int32 — canonical answer ids per probe sample.
    Returns (B,) float32 sigma values. Distinct-count is computed by
    pairwise comparison (N is small — the paper uses N=3).
    """
    b, n = answer_ids.shape
    # distinct count: sum over i of [a_i not equal to any earlier a_j]
    eq = answer_ids[:, :, None] == answer_ids[:, None, :]   # (B,N,N)
    earlier = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                    device=answer_ids.device),
                         diagonal=-1)                       # j < i
    dup = torch.any(eq & earlier[None], dim=-1)             # (B,N)
    distinct = n - dup.sum(dim=-1)                          # (B,)
    return (distinct - 1).to(torch.float32) / (n - 1)


def route_batch(sig: torch.Tensor) -> torch.Tensor:
    """Map sigma values to mode ids: 0=single_agent, 1=arena_lite,
    2=full_arena. sig: (B,) float32."""
    one = torch.ones_like(sig, dtype=torch.int32)
    return torch.where(sig <= 0.0, 0 * one,
                       torch.where(sig < 1.0, one, 2 * one))


MODE_NAMES = ("single_agent", "arena_lite", "full_arena")


def majority_vote_batch(answer_ids: torch.Tensor) -> torch.Tensor:
    """Majority answer id per row (ties -> first sample), (B, N) int32."""
    eq = (answer_ids[:, :, None] == answer_ids[:, None, :]).sum(-1)
    best = torch.argmax(eq, dim=-1)                         # (B,)
    return torch.gather(answer_ids, 1, best[:, None])[:, 0]
