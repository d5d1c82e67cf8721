"""The one traffic generator: every stream of a mix, under every seed,
holds the same work in another order."""
import json
from collections import Counter
from pathlib import Path

import pytest

from perfbench.harness import traffic
from perfbench.reference import acar

PKG = Path(__file__).resolve().parents[1]
MIXES = sorted(p.stem for p in (PKG / "traffic").glob("*.json"))


def _mix(name):
    return json.loads((PKG / "traffic" / f"{name}.json").read_text())


def _work(tasks, routes):
    return Counter(zip((t.prompt_tokens for t in tasks), routes.tolist()))


@pytest.mark.parametrize("mix", MIXES)
def test_streams_hold_the_same_work_in_another_order(mix):
    """Every stream holds the same work; its index alone orders it, so
    seeds differ in the prompts' digits only."""
    m = _mix(mix)
    base = _work(*traffic.stream(m, 1, 1))
    orders = set()
    for index in (1, 2, 9):
        tasks, routes = traffic.stream(m, 5, index)
        assert _work(tasks, routes) == base
        orders.add(tuple(t.prompt_tokens for t in tasks))
        other, other_routes = traffic.stream(m, 2 ** 31 + 77, index)
        assert [t.prompt_tokens for t in other] == [
            t.prompt_tokens for t in tasks]
        assert (other_routes == routes).all()
        assert [t.text for t in other] != [t.text for t in tasks]
    assert len(orders) == 3
    block = m["routes_per_block"]
    counts = Counter(routes.tolist())
    scale = m["stream_tasks"] // sum(block)
    assert [counts[r] for r in range(3)] == [c * scale for c in block]


@pytest.mark.parametrize("mix", MIXES)
def test_prompts_and_resubmissions(mix):
    m = _mix(mix)
    tasks, _ = traffic.stream(m, 2 ** 31 + 9, 3)
    again, _ = traffic.stream(m, 2 ** 31 + 9, 3)
    assert [t.text for t in tasks] == [t.text for t in again]
    seen = {}
    repeats = 0
    for i, t in enumerate(tasks):
        assert len(acar.encode(t.text)) == t.prompt_tokens
        assert t.prompt_tokens in m["prompt_tokens"]["snap_to"]
        if t.task_id in seen:
            repeats += 1
            assert i - seen[t.task_id] <= m["resubmit"]["within"] + repeats
            assert t.text == tasks[seen[t.task_id]].text
        else:
            seen[t.task_id] = i
    assert repeats == round(m["resubmit"]["share"] * m["stream_tasks"])


def test_the_warm_up_order_starts_at_the_longest_prompt():
    tasks, _ = traffic.longest_first(*traffic.stream(_mix("prompt"), 1, 0))
    lengths = [t.prompt_tokens for t in tasks]
    assert lengths == sorted(lengths, reverse=True)
