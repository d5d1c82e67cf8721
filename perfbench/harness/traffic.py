"""The one generator of every traffic mix (``traffic/<name>.json``).

A stream is ``stream_tasks`` tasks served back to back by one
``run_stepped`` call. Every stream of a mix, under every seed, holds
the same multiset of (prompt length, route) slots: the lengths are the
mix's log-normal quantiles snapped to its grid, the routes the mix's
block (the paper's 13 single / 4 arena-lite / 7 full-arena per 24)
spread over the lengths, and a ``resubmit.share`` of the slots repeat
an earlier prompt of the same length. The stream's index chooses the
order and the resubmissions' places (each at most ``resubmit.within``
tasks after its source); the seed chooses only the prompts' digits
(and, elsewhere, the weights). Rows decode together only at one prompt
length, so the order sets how the work batches: every seed gets the
same work in the same arrangement.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import List

import numpy as np

# the characters of a prompt: digits, then the arithmetic surface's tail
TAIL = " + 1 = "
# BOS, then the text; the serving path appends no further token to a
# text that ends in a space
_EXTRA_TOKENS = 1 + len(TAIL)


@dataclass(frozen=True)
class Slot:
    prompt_tokens: int
    mode: int
    source: int          # index of the fresh slot it repeats, or -1


@dataclass(frozen=True)
class StreamTask:
    task_id: str
    text: str
    kind: str
    prompt_tokens: int


def _snap(x: float, grid: List[int]) -> int:
    """The grid value nearest ``x``, the larger on a tie."""
    return min(grid, key=lambda g: (abs(g - x), -g))


def slots(traffic: dict) -> List[Slot]:
    """The mix's fixed multiset of slots: fresh slots in order of
    length, then the resubmissions."""
    n = int(traffic["stream_tasks"])
    n_resub = int(round(traffic["resubmit"]["share"] * n))
    n_fresh = n - n_resub
    pt = traffic["prompt_tokens"]
    mu, sd = math.log(pt["lognormal_median"]), pt["lognormal_sigma"]
    z = NormalDist()
    lengths = sorted(
        _snap(math.exp(mu + sd * z.inv_cdf((i + 0.5) / n_fresh)),
              pt["snap_to"])
        for i in range(n_fresh))
    sources = [min(n_fresh - 1, int((j + 0.5) * n_fresh / n_resub))
               for j in range(n_resub)]
    all_lengths = lengths + [lengths[s] for s in sources]
    # spread each route over the lengths: the k-th slot in length order
    # takes the route furthest behind its share so far
    block = traffic["routes_per_block"]
    want = [c * n / sum(block) for c in block]
    if any(abs(w - round(w)) > 1e-9 for w in want):
        raise ValueError(f"{traffic['name']}: {n} tasks a stream is not a "
                         f"whole number of route blocks {block}")
    order = sorted(range(n), key=lambda i: (all_lengths[i], i))
    got = [0] * len(block)
    modes = [0] * n
    for k, i in enumerate(order):
        m = max(range(len(block)),
                key=lambda r: (want[r] * (k + 1) / n - got[r], -r))
        got[m] += 1
        modes[i] = m
    return [Slot(all_lengths[i], modes[i], -1 if i < n_fresh
                 else sources[i - n_fresh]) for i in range(n)]


def stream(traffic: dict, seed: int, index: int):
    """Stream ``index`` of the mix under ``seed``: (tasks, routes), the
    routes keyed by position in the stream (the admission index). The
    order and the resubmissions' places follow the stream's index alone,
    the digits the seed too."""
    rng = np.random.default_rng([int(index), 0x5EED])
    digits_rng = np.random.default_rng([int(seed), int(index), 0xD161])
    sl = slots(traffic)
    fresh = [i for i, s in enumerate(sl) if s.source < 0]
    resub = [i for i, s in enumerate(sl) if s.source >= 0]
    order = [fresh[i] for i in rng.permutation(len(fresh))]
    within = int(traffic["resubmit"]["within"])
    for i in resub:
        at = order.index(sl[i].source)
        order.insert(at + 1 + int(rng.integers(within)), i)
    texts = {}
    for i in fresh:
        n_digits = sl[i].prompt_tokens - _EXTRA_TOKENS
        digits = digits_rng.integers(0, 10, n_digits)
        texts[i] = "".join(map(str, digits.tolist())) + TAIL
    tasks = []
    for i in order:
        src = i if sl[i].source < 0 else sl[i].source
        tasks.append(StreamTask(
            task_id=f"{traffic['name']}-{index}-{src}", text=texts[src],
            kind=traffic["kind"], prompt_tokens=sl[src].prompt_tokens))
    routes = np.asarray([sl[i].mode for i in order], np.int32)
    return tasks, routes


def longest_first(tasks, routes):
    """A stream reordered by prompt length, longest first: the warm-up
    order, so the page pools are sized once, for the longest prompt."""
    order = sorted(range(len(tasks)), key=lambda i: -tasks[i].prompt_tokens)
    return [tasks[i] for i in order], routes[order]
