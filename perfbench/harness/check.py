"""How ``correct`` is decided: the outputs the timed streams produced,
held to the plain reference once the window has closed.

Three numbers are compared, each with its limit
(``limits/<workload>.json``; an exact comparison's limit is 0):

- ``logit_gap``: over a sample of the window's finished tasks, drawn
  from the seed and holding the task with the longest prompt among
  those a member served, every token a greedy member (temperature 0)
  served is scored by the float32 reference over the prompt and the
  tokens before it; the number is the widest gap by which a served
  token's reference logit lies below the reference's best at its
  position. The twin decodes on the probe's own prefill (pages or
  lanes), so the probe's model is checked through it; the probe's own
  samples are drawn at temperature 0.7 and are checked through the
  replay below.
- ``answer_mismatches``: for every task of the window, the host's
  work replayed from the served tokens (``reference/acar.py``): each
  sample's text and answer, sigma, the forced route, each member's
  answer and the judge's. A task counts once where sigma, the route or
  the final answer differs from what the program returned.
- ``unanswered``: tasks of the window that did not retire with an
  answer.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from perfbench.reference import acar, common, dense, mamba

REFERENCES = {"dense": dense, "ssm": mamba}


def replay(streams, config: dict) -> Dict[str, int]:
    """``answer_mismatches`` and ``unanswered`` over every stream."""
    n_members = len(config["ensemble"])
    mismatches = unanswered = 0
    for st in streams:
        res = st.result
        for adm, task in enumerate(st.tasks):
            final = res.final_answers[adm]
            if final is None:
                unanswered += 1
                continue
            rec = st.records.get(adm)
            if rec is None or len(rec.probe_tokens) == 0:
                mismatches += 1
                continue
            answers = [acar.extract_math(acar.decode(t))
                       for t in rec.probe_tokens]
            sig = acar.sigma(answers)
            mode = int(st.routes[adm])
            members = [None] * n_members
            for mi in acar.members_of(mode, n_members):
                toks = rec.member_tokens.get(mi)
                members[mi] = (None if toks is None
                               else acar.extract_math(acar.decode(toks)))
            want = acar.judge(mode, acar.majority(answers), members)
            if (abs(float(res.sigma[adm]) - sig) > 0
                    or int(res.modes[adm]) != mode or final != want):
                mismatches += 1
    return {"answer_mismatches": mismatches, "unanswered": unanswered}


def sample(streams, config: dict, seed: int, min_tokens: int) -> List[dict]:
    """(model, weights, prompt, served tokens) of greedy member decodes:
    the longest-prompt task a member served, a task of each member that
    task lacks, then tasks drawn from the seed until ``min_tokens``
    served tokens are in."""
    ens = config["ensemble"]
    cands = []
    for st in streams:
        for adm, task in enumerate(st.tasks):
            rec = st.records.get(adm)
            if rec is None or not rec.member_tokens:
                continue
            cands.append((st.index, adm, task, rec))
    if not cands:
        return []
    rng = np.random.default_rng([int(seed), 0xC4EC])
    longest = max(range(len(cands)),
                  key=lambda i: (len(acar.encode(cands[i][2].text)),
                                 len(cands[i][3].member_tokens), -i))
    rest = [int(i) for i in rng.permutation(len(cands)) if i != longest]
    order = [longest]
    # then a task of each member the picks so far miss, so every model
    # of the fleet is scored
    for mi in range(len(ens)):
        if not any(mi in cands[i][3].member_tokens for i in order):
            first = next((i for i in rest
                          if mi in cands[i][3].member_tokens), None)
            if first is not None:
                rest.remove(first)
                order.append(first)
    n_first = len(order)
    order += rest
    picked, tokens = [], 0
    for k, i in enumerate(order):
        if k >= n_first and tokens >= min_tokens:
            break
        _, _, task, rec = cands[i]
        for mi, toks in sorted(rec.member_tokens.items()):
            if not toks:
                continue
            picked.append({"model": ens[mi]["model"],
                           "weights": ens[mi]["weights"],
                           "member": ens[mi]["name"],
                           "prompt": acar.encode(task.text),
                           "served": list(toks)})
            tokens += len(toks)
    return picked


def score(picked: List[dict], config: dict, weights: dict, device,
          precisions=("f32",)) -> Dict[str, float]:
    """The widest gap (``logit_gap``) over the picked decodes, and with
    ``"fp8"`` among ``precisions`` the gap of the token the fp8 control
    puts first at each of the same positions (``control_gap``)."""
    common.float32_exact()
    worst = {p: 0.0 for p in precisions}
    n_tokens = 0
    for item in picked:
        m = config["models"][item["model"]]
        w = weights[(item["model"], item["weights"])]
        ref = REFERENCES[m["family"]]
        served = item["served"]
        seq = torch.tensor(item["prompt"] + served[:-1], device=device)
        exact = ref.logits(m, w, seq, len(served), "f32")
        best = exact.max(dim=-1).values
        idx = torch.arange(len(served), device=device)
        got = exact[idx, torch.tensor(served, device=device)]
        worst["f32"] = max(worst["f32"], float((best - got).max()))
        if "fp8" in precisions:
            low = ref.logits(m, w, seq, len(served), "fp8").argmax(-1)
            worst["fp8"] = max(worst["fp8"],
                               float((best - exact[idx, low]).max()))
        n_tokens += len(served)
        del exact
    out = {"logit_gap": worst["f32"], "tokens_checked": n_tokens}
    if "fp8" in precisions:
        out["control_gap"] = worst["fp8"]
    return out


def judge_numbers(numbers: Dict[str, float],
                  limits: Dict[str, float]) -> Dict[str, dict]:
    """Each compared number beside its limit; a number passes at or
    under it."""
    return {k: {"value": numbers[k], "limit": limits[k],
                "ok": bool(numbers[k] <= limits[k])} for k in limits}
