"""Synthetic task suites.

Two suites:

* ``paper_suite`` — 1,510 tasks mirroring the paper's benchmark mix
  (MathArena 60 / Reasoning Gym 250 / LiveCodeBench 200 / SuperGPQA
  1,000) with latent difficulty distributions per benchmark. Used with
  the calibrated SyntheticBackend to regenerate the paper's tables.
* ``arithmetic_suite`` — genuinely solvable few-token arithmetic tasks
  used with real (tiny) zoo models, so the
  full probe -> sigma -> route -> ensemble path executes end to end.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

BENCHMARKS = ("matharena", "reasoning_gym", "livecodebench", "supergpqa")
PAPER_MIX = {
    "matharena": 60,
    "reasoning_gym": 250,
    "livecodebench": 200,
    "supergpqa": 1000,
}
BENCH_KIND = {
    "matharena": "math",
    "reasoning_gym": "reasoning",
    "livecodebench": "code",
    "supergpqa": "mcq",
}

# latent difficulty ~ N(mu, sd), higher = harder. Tuned so that the
# calibrated model-skill profile reproduces the paper's per-benchmark
# accuracies (see benchmarks/table1_overall.py).
# difficulty is a BIMODAL mixture (paper Fig. 1: bimodality is what
# makes routing effective): (p_easy, mu_easy, sd_easy, mu_hard, sd_hard)
BENCH_DIFFICULTY = {
    "matharena": (0.05, -0.5, 0.4, 2.2, 0.7),
    "reasoning_gym": (0.18, -1.2, 0.5, 1.15, 0.8),
    "livecodebench": (0.15, -1.0, 0.5, 0.8, 0.8),
    "supergpqa": (0.33, -1.5, 0.5, 1.2, 0.7),
}
# size of the per-task wrong-answer pool and its concentration: a small,
# concentrated pool yields correlated errors -> agreement-but-wrong.
BENCH_CONFUSION = {
    "matharena": (45, 0.98),    # diverse wrong numbers -> sigma=1 (93%)
    "reasoning_gym": (20, 0.95),
    "livecodebench": (8, 0.6),
    "supergpqa": (9, 0.65),     # 10-option MCQ (SuperGPQA)
}


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


def _mk_wrong_pool(rng: np.random.Generator, kind: str, gold: str,
                   size: int, conc: float):
    if kind == "mcq":
        pool = [c for c in "ABCDEFGHIJ" if c != gold][:size]
    elif kind == "math":
        base = int(float(gold)) if gold.lstrip("-").isdigit() else 0
        deltas = rng.choice(np.arange(1, 50), size=size, replace=False)
        signs = rng.choice([-1, 1], size=size)
        pool = [str(base + int(d) * int(s))
                for d, s in zip(deltas, signs)]
    else:
        pool = [f"alt_{i}_{rng.integers(1 << 30)}" for i in range(size)]
    w = np.array([conc ** i for i in range(len(pool))], np.float64)
    w /= w.sum()
    return tuple(pool), tuple(float(x) for x in w)


def paper_suite(seed: int = 0) -> List[Task]:
    """1,510 tasks mirroring the paper's benchmark mix."""
    rng = np.random.default_rng(seed)
    tasks: List[Task] = []
    for bench in BENCHMARKS:
        n = PAPER_MIX[bench]
        kind = BENCH_KIND[bench]
        p_easy, mu_e, sd_e, mu_h, sd_h = BENCH_DIFFICULTY[bench]
        pool_size, conc = BENCH_CONFUSION[bench]
        for i in range(n):
            if rng.random() < p_easy:
                d = float(rng.normal(mu_e, sd_e))
            else:
                d = float(rng.normal(mu_h, sd_h))
            if kind == "mcq":
                gold = "ABCDEFGHIJ"[rng.integers(10)]
            elif kind == "math":
                gold = str(int(rng.integers(-500, 500)))
            elif kind == "code":
                gold = f"impl_{rng.integers(1 << 30)}"
            else:
                gold = f"concl_{rng.integers(1 << 30)}"
            pool, w = _mk_wrong_pool(rng, kind, gold, pool_size, conc)
            tasks.append(Task(
                task_id=f"{bench}-{i:04d}",
                benchmark=bench,
                kind=kind,
                # diverse token surface -> realistic low cross-task
                # retrieval similarity (the paper's 0.167 median regime)
                text=" ".join(
                    f"w{rng.integers(300_000)}" for _ in range(16)),
                gold=gold,
                difficulty=d,
                wrong_pool=pool,
                wrong_weights=w,
            ))
    return tasks


# ----------------------------------------------------------------------
# genuinely solvable arithmetic tasks for the real-model paths
# ----------------------------------------------------------------------
def arithmetic_suite(n: int = 64, seed: int = 0,
                     max_operand: int = 9) -> List[Task]:
    rng = np.random.default_rng(seed)
    tasks = []
    for i in range(n):
        a = int(rng.integers(0, max_operand + 1))
        b = int(rng.integers(0, max_operand + 1))
        op = rng.choice(["+", "-"])
        gold = a + b if op == "+" else a - b
        tasks.append(Task(
            task_id=f"arith-{i:04d}",
            benchmark="arithmetic",
            kind="math",
            text=f"{a} {op} {b} =",
            gold=str(gold),
            difficulty=0.0,
        ))
    return tasks


def split_by_benchmark(tasks: List[Task]) -> Dict[str, List[Task]]:
    out: Dict[str, List[Task]] = {}
    for t in tasks:
        out.setdefault(t.benchmark, []).append(t)
    return out
