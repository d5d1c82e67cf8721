"""JudgeSelect (paper Alg. 1 line 17) and answer aggregation.

The paper treats the judge as a black box that selects among ensemble
responses. We implement a deterministic score-weighted plurality judge:
each response carries a judge-visible quality score (confidence /
formatting heuristics — in the calibrated simulator this correlates
with correctness, as a competent black-box judge does); an answer's
weight is its vote count plus ``JUDGE_SCORE_WEIGHT`` times its total
score. Plurality therefore dominates — two models agreeing on a wrong
answer still outvote one correct model (the paper's agreement-but-wrong
ceiling, §6.2) — while ties and all-distinct cases resolve toward the
more convincing response. Residual exact ties break by (a) agreement
with the probe majority, then (b) a seeded, model-order-stable coin
derived from the task id — fully reproducible given the trace.
"""
from __future__ import annotations

import hashlib
from collections import defaultdict
from typing import Dict, Optional, Sequence

from repro_torch.teamllm.trace import ModelResponse

JUDGE_SCORE_WEIGHT = 0.45


def _stable_coin(task_id: str, options: Sequence[str]) -> str:
    h = hashlib.sha256(task_id.encode()).digest()
    return sorted(options)[h[0] % len(options)]


def judge_select(responses: Sequence[ModelResponse], task_id: str,
                 probe_answer: Optional[str] = None,
                 score_weight: float = JUDGE_SCORE_WEIGHT) -> str:
    """Select the final answer among model responses."""
    weight: Dict[str, float] = defaultdict(float)
    for r in responses:
        weight[r.answer] += 1.0 + score_weight * r.score
    top = max(weight.values())
    winners = sorted(a for a, w in weight.items()
                     if abs(w - top) < 1e-9)
    if len(winners) == 1:
        return winners[0]
    if probe_answer is not None and probe_answer in winners:
        return probe_answer
    return _stable_coin(task_id, winners)


def arena_verify(probe_majority: str,
                 responses: Sequence[ModelResponse],
                 task_id: str) -> str:
    """arena_lite (Alg. 1 lines 11-14): the probe majority stands unless
    the verification models unanimously contradict it with a common
    alternative."""
    answers = [r.answer for r in responses]
    if answers and all(a == answers[0] for a in answers) \
            and answers[0] != probe_majority:
        return answers[0]
    return probe_majority
