"""EXTRACT: map a model response to a canonical answer representation
(paper §3.2.1). Domain-specific comparison logic per benchmark kind:

* math      — last number in the response, normalised (strip trailing
              zeros, unify integer/float forms);
* mcq       — first standalone choice letter A-J (SuperGPQA is 10-option);
* reasoning — final token sequence after "answer:" (or whole string),
              lowercased/stripped;
* code      — whitespace/comment-normalised body. The paper notes code
              outputs are rarely canonical (inflating escalation); the
              ``canonicalize_code`` flag reproduces that knob.
"""
from __future__ import annotations

import re
from typing import Optional

_NUM_RE = re.compile(r"-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?")
_CHOICE_RE = re.compile(r"\b([A-J])\b")
# 10-option MCQ: "A" and "I" are English words; only treat them as
# choices in explicit contexts ("(A)", "option I", "answer: A").
_CHOICE_STRICT_RE = re.compile(
    r"\(([A-J])\)|(?:option|choice)\s+([A-J])\b", re.IGNORECASE)
_CHOICE_SAFE_RE = re.compile(r"\b([B-HJ])\b")
_ANSWER_RE = re.compile(r"answer\s*[:=]\s*(.+)", re.IGNORECASE)


def _norm_number(tok: str) -> str:
    try:
        v = float(tok)
    except ValueError:
        return tok
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def extract_math(response: str) -> str:
    nums = _NUM_RE.findall(response)
    if not nums:
        return response.strip().lower()[:64]
    return _norm_number(nums[-1])


def extract_mcq(response: str) -> str:
    m = _ANSWER_RE.search(response)
    if m:
        c = _CHOICE_RE.search(m.group(1))
        if c:
            return c.group(1).upper()
    m = _CHOICE_STRICT_RE.search(response)
    if m:
        return (m.group(1) or m.group(2)).upper()
    c = _CHOICE_SAFE_RE.search(response)
    if c:
        return c.group(1)
    c = _CHOICE_RE.search(response)
    return c.group(1) if c else response.strip().upper()[:8]


def extract_reasoning(response: str) -> str:
    m = _ANSWER_RE.search(response)
    text = m.group(1) if m else response
    return " ".join(text.lower().split())[:64]


_COMMENT_RE = re.compile(r"#[^\n]*|//[^\n]*")


def extract_code(response: str, canonicalize: bool = True) -> str:
    """Code answers: strip comments + normalise whitespace when
    ``canonicalize``; otherwise compare raw text (the paper's setting,
    which inflates full_arena escalation on LiveCodeBench to 96%)."""
    if not canonicalize:
        return response.strip()
    body = _COMMENT_RE.sub("", response)
    lines = [" ".join(l.split()) for l in body.splitlines()]
    return "\n".join(l for l in lines if l)


_EXTRACTORS = {
    "math": extract_math,
    "mcq": extract_mcq,
    "reasoning": extract_reasoning,
}


def extract(response: str, kind: str,
            canonicalize_code: bool = False) -> str:
    if kind == "code":
        return extract_code(response, canonicalize=canonicalize_code)
    fn = _EXTRACTORS.get(kind)
    if fn is None:
        return extract_reasoning(response)
    return fn(response)


def extract_batch(responses, kinds,
                  canonicalize_code: bool = False) -> list:
    """Extract a whole tick's worth of responses in one call.

    Element-wise identical to ``[extract(r, k) for r, k in zip(...)]``
    — extraction is a pure per-response function, so batching is purely
    an execution strategy (the step-level serving loop collects every
    row routing in the same tick here instead of calling ``extract``
    once per row). Duplicate (response, kind) pairs — N probe samples
    that decoded the same text, duplicate-bearing request streams —
    are extracted once and shared.
    """
    if len(responses) != len(kinds):
        raise ValueError(
            f"{len(responses)} responses vs {len(kinds)} kinds")
    memo: dict = {}
    out = []
    for r, k in zip(responses, kinds):
        key = (r, k)
        if key not in memo:
            memo[key] = extract(r, k,
                                canonicalize_code=canonicalize_code)
        out.append(memo[key])
    return out
