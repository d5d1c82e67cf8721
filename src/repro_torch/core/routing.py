"""ACAR routing (paper Alg. 1, Def. 2): sigma -> execution mode."""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import List, Sequence

SINGLE_AGENT = "single_agent"
ARENA_LITE = "arena_lite"
FULL_ARENA = "full_arena"

MODES = (SINGLE_AGENT, ARENA_LITE, FULL_ARENA)


def execution_mode(sigma: float) -> str:
    """Def. 2: M(sigma)."""
    if sigma <= 0.0:
        return SINGLE_AGENT
    if sigma < 1.0:
        return ARENA_LITE
    return FULL_ARENA


def models_for_mode(mode: str, ensemble: Sequence[str],
                    arena_lite_size: int = 2) -> List[str]:
    """Which ensemble members execute in each mode (Alg. 1 lines 8-19)."""
    if mode == SINGLE_AGENT:
        return []                       # probe consensus answer is final
    if mode == ARENA_LITE:
        return list(ensemble[:arena_lite_size])
    return list(ensemble)


def degrade_mode(mode: int, healthy: Sequence[bool],
                 arena_lite_size: int = 2) -> int:
    """Graceful degradation ladder over unhealthy ensemble members:
    the highest integer mode (0=single_agent, 1=arena_lite,
    2=full_arena) at-or-below ``mode`` that the healthy members can
    still execute. full_arena survives while *any* member is healthy
    (it runs over the healthy subset); arena_lite needs a healthy
    member among the first ``arena_lite_size`` (those are the only
    members it consults); with no healthy member the probe consensus
    is final (single_agent). Pure and deterministic, so degraded
    routing replays bit-identically under the same fault plan."""
    if mode <= 0:
        return 0
    if mode >= 2 and any(healthy):
        return 2
    if any(healthy[:arena_lite_size]):
        return 1
    return 0


def majority_vote(answers: Sequence[str]) -> str:
    """MajorityVote over extracted answers; ties break to first seen."""
    counts = Counter(answers)
    top = max(counts.values())
    for a in answers:
        if counts[a] == top:
            return a
    raise AssertionError("unreachable")


@dataclass(frozen=True)
class RoutingDecision:
    sigma: float
    mode: str
    executed_models: tuple
    probe_answer: str          # consensus / majority probe answer

    @property
    def ensemble_calls_saved(self) -> int:
        """Calls avoided vs always-full-arena (3 models)."""
        return 3 - len(self.executed_models)


def decide(sigma_value: float, probe_answers: Sequence[str],
           ensemble: Sequence[str],
           arena_lite_size: int = 2) -> RoutingDecision:
    mode = execution_mode(sigma_value)
    return RoutingDecision(
        sigma=sigma_value,
        mode=mode,
        executed_models=tuple(models_for_mode(mode, ensemble,
                                              arena_lite_size)),
        probe_answer=majority_vote(probe_answers),
    )
