"""What ACAR's host makes of a task's tokens (paper Algorithm 1), as
plain Python: the char tokenizer's text, the math answer extractor,
sigma over the N probe answers, the majority, and the judge over the
members' answers under the task's route. A frozen copy of the
published rules, kept here so the check reads nothing of the program.
"""
from __future__ import annotations

import re
from typing import List, Optional, Sequence

PAD, BOS, EOS = 0, 1, 2
CHARS = "0123456789+-*= ."
_NUM_RE = re.compile(r"-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?")


def encode(text: str) -> List[int]:
    """BOS, then one id a character of ``CHARS`` (others dropped)."""
    return [BOS] + [CHARS.index(c) + 3 for c in text if c in CHARS]


def decode(ids: Sequence[int]) -> str:
    """Text of ids up to the first EOS; PAD, BOS and ids outside the
    character table give nothing."""
    out = []
    for i in ids:
        if i == EOS:
            break
        if 3 <= i < 3 + len(CHARS):
            out.append(CHARS[i - 3])
    return "".join(out)


def extract_math(text: str) -> str:
    """The last number of the text, as an integer where it is one; the
    text itself, stripped, lowercased and cut to 64, if it has none."""
    nums = _NUM_RE.findall(text)
    if not nums:
        return text.strip().lower()[:64]
    try:
        v = float(nums[-1])
    except ValueError:
        return nums[-1]
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def sigma(answers: Sequence[str]) -> float:
    """(distinct answers - 1) / (N - 1)."""
    n = len(answers)
    return 0.0 if n < 2 else (len(set(answers)) - 1) / (n - 1)


def majority(answers: Sequence[str]) -> str:
    """The answer most samples agree with, the first on a tie."""
    votes = [sum(a == b for b in answers) for a in answers]
    return answers[votes.index(max(votes))]


def judge(mode: int, probe_major: str,
          members: Sequence[Optional[str]]) -> str:
    """single (0): the probe's majority. arena-lite (1): the probe's
    majority unless the first two members agree on another answer.
    full arena (2): the plurality of the members' answers, an answer the
    probe's majority shares winning a tie, then the first member."""
    if mode == 0:
        return probe_major
    if mode == 1:
        j = min(1, len(members) - 1)
        a, b = members[0], members[j]
        if a is not None and a == b and a != probe_major:
            return a
        return probe_major
    best, best_score = None, -1
    for a in members:
        if a is None:
            continue
        score = 2 * sum(a == b for b in members if b is not None) \
            + int(a == probe_major)
        if score > best_score:
            best, best_score = a, score
    return best


def members_of(mode: int, n_members: int, arena_lite_size: int = 2):
    """The members a route runs: none, the first ``arena_lite_size``, or
    all."""
    if mode == 0:
        return []
    if mode == 1:
        return list(range(min(arena_lite_size, n_members)))
    return list(range(n_members))
