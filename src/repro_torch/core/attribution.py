"""Model attribution (paper §6.3): ground-truth counterfactuals vs
proxy signals.

Ground truth: leave-one-out (LOO) values and exact Shapley values over
the 2^3 coalitions, computed by *re-running the judge* on each subset —
explicit counterfactual computation, exactly what the paper concludes
is required.

Proxies: response-similarity-to-final-answer, output entropy, and
agreement patterns — the signals the paper shows do NOT correlate with
ground truth. ``proxy_vs_truth_correlation`` quantifies it.
"""
from __future__ import annotations

import itertools
import math
from collections import Counter
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.judge import judge_select
from repro_torch.core.retrieval import embed_text
from repro_torch.teamllm.trace import ModelResponse

CoalitionValue = Callable[[Sequence[ModelResponse]], float]


def coalition_accuracy(responses: Sequence[ModelResponse], task_id: str,
                       gold: str) -> float:
    """v(S): did the judge over subset S produce the gold answer?"""
    if not responses:
        return 0.0
    return float(judge_select(responses, task_id) == gold)


def leave_one_out(responses: Sequence[ModelResponse], task_id: str,
                  gold: str) -> Dict[str, float]:
    """LOO_i = v(N) - v(N \\ {i})."""
    full = coalition_accuracy(responses, task_id, gold)
    out = {}
    for i, r in enumerate(responses):
        rest = [x for j, x in enumerate(responses) if j != i]
        out[r.model] = full - coalition_accuracy(rest, task_id, gold)
    return out


def shapley(responses: Sequence[ModelResponse], task_id: str,
            gold: str) -> Dict[str, float]:
    """Exact Shapley values over all 2^n coalitions (n = 3 here)."""
    n = len(responses)
    idx = list(range(n))
    values: Dict[frozenset, float] = {}
    for r in range(n + 1):
        for subset in itertools.combinations(idx, r):
            values[frozenset(subset)] = coalition_accuracy(
                [responses[i] for i in subset], task_id, gold)
    out = {r.model: 0.0 for r in responses}
    for i in idx:
        phi = 0.0
        others = [j for j in idx if j != i]
        for r in range(n):
            for subset in itertools.combinations(others, r):
                s = frozenset(subset)
                w = (math.factorial(len(s))
                     * math.factorial(n - len(s) - 1) / math.factorial(n))
                phi += w * (values[s | {i}] - values[s])
        out[responses[i].model] = phi
    return out


# ----------------------------------------------------------------------
# proxy signals (the ones that fail)
# ----------------------------------------------------------------------
def proxy_similarity(responses: Sequence[ModelResponse],
                     final_answer: str) -> Dict[str, float]:
    """Cosine similarity of each response to the final answer text."""
    fvec = embed_text(final_answer)
    return {r.model: float(embed_text(r.response) @ fvec)
            for r in responses}


def proxy_entropy(responses: Sequence[ModelResponse]) -> Dict[str, float]:
    """Negative token-distribution entropy (lower entropy -> claimed
    higher contribution)."""
    out = {}
    for r in responses:
        toks = r.response.lower().split() or [""]
        counts = Counter(toks)
        total = sum(counts.values())
        ent = -sum((c / total) * math.log(c / total + 1e-12)
                   for c in counts.values())
        out[r.model] = -ent
    return out


def proxy_agreement(responses: Sequence[ModelResponse]) -> Dict[str, float]:
    """Fraction of other models agreeing with each response."""
    out = {}
    for r in responses:
        others = [x for x in responses if x.model != r.model]
        if not others:
            out[r.model] = 0.0
            continue
        out[r.model] = sum(x.answer == r.answer for x in others) \
            / len(others)
    return out


def proxy_vs_truth_correlation(
        truth_rows: List[Dict[str, float]],
        proxy_rows: List[Dict[str, float]]) -> float:
    """Pearson correlation between flattened per-(task, model) values."""
    t, p = [], []
    for tr, pr in zip(truth_rows, proxy_rows):
        for m in tr:
            if m in pr:
                t.append(tr[m])
                p.append(pr[m])
    if len(t) < 2:
        return 0.0
    t_arr, p_arr = np.asarray(t), np.asarray(p)
    if t_arr.std() == 0 or p_arr.std() == 0:
        return 0.0
    return float(np.corrcoef(t_arr, p_arr)[0, 1])
