"""Model backends for the ACAR orchestrator.

``ModelBackend`` is the provider abstraction (paper: Claude / GPT-4o /
Gemini). Two implementations:

* ``SyntheticBackend`` — deterministic, seeded simulator whose per-task
  correctness statistics are calibrated to the paper's published
  numbers. It replaces the unreachable frontier APIs (repro gate, see
  DESIGN.md) while exercising the *identical* routing/trace machinery.
* ``TorchModelBackend`` (in serving/torch_backend.py) — real zoo
  models run by this package's sampler, on the device holding their
  params.

The simulator's generative model: each task has latent difficulty z;
model m answers correctly with probability sigmoid(skill_m - z). Wrong
answers are drawn from the task's finite confusion pool (shared across
models -> correlated errors -> the paper's "agreement-but-wrong" mode).
Code responses get a non-canonical nonce with high probability,
reproducing the paper's inflated LiveCodeBench escalation (§8).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, Optional, Protocol, Sequence, Tuple

import numpy as np

from repro_torch.data.tasks import Task


class ModelBackend(Protocol):
    name: str

    def generate(self, task: Task, prompt: str, *, temperature: float,
                 sample_idx: int, seed: int) -> "GenResult":
        ...


@dataclass(frozen=True)
class GenResult:
    response: str              # raw response text
    semantic_answer: str       # ground-truth-comparable answer
    cost: float
    latency_ms: float
    # judge-visible quality signal; correlates with correctness in the
    # calibrated simulator (a competent black-box judge's view).
    score: float = 0.0


@dataclass(frozen=True)
class ModelProfile:
    name: str
    skill: float               # logit offset vs task difficulty
    cost_per_call: float
    latency_mean_ms: float
    latency_sigma: float       # lognormal sigma
    # per-benchmark skill adjustments (e.g. code-specialised models)
    bench_skill: Dict[str, float] = field(default_factory=dict)
    # confident-misconception rate: on a trapped (model, task) pair the
    # model consistently produces the same wrong answer regardless of
    # temperature -- the paper's "agreement-but-wrong" mechanism (S6.2).
    # Scaled per benchmark: misconceptions live in knowledge/reasoning
    # tasks; competition math / verified code rarely reward confident
    # wrong answers consistently.
    trap_p: float = 0.10


# calibrated to the paper's Table 1 / Fig. 3 (see EXPERIMENTS.md):
#   claude-sonnet-4 single-model overall = 45.4%
#   arena ensembles and probe behaviour per §5
PAPER_MODELS = {
    "claude-sonnet-4": ModelProfile(
        "claude-sonnet-4", skill=0.0, cost_per_call=0.01129,
        latency_mean_ms=6200.0, latency_sigma=0.45,
        bench_skill={"supergpqa": 0.76, "matharena": 0.88,
                     "reasoning_gym": 0.19, "livecodebench": 0.05}),
    "gpt-4o": ModelProfile(
        "gpt-4o", skill=0.0, cost_per_call=0.00155,
        latency_mean_ms=4800.0, latency_sigma=0.5,
        bench_skill={"supergpqa": 0.36, "matharena": 0.73,
                     "reasoning_gym": 0.13, "livecodebench": 0.00}),
    "gemini-2.0-flash": ModelProfile(
        "gemini-2.0-flash", skill=0.0, cost_per_call=0.00004,
        latency_mean_ms=1400.0, latency_sigma=0.4,
        bench_skill={"supergpqa": 1.15, "matharena": 0.42,
                     "reasoning_gym": 0.50, "livecodebench": 0.00},
        trap_p=0.17),  # flash probe: more confident misconceptions
}

# probability that a code response is non-canonical (unique formatting)
CODE_NONCE_P = 0.85
TRAP_BENCH_FACTOR = {
    "supergpqa": 0.6,       # misconception-prone knowledge MCQ
    "reasoning_gym": 0.6,
    "matharena": 0.10,      # competition math: wrong != consistent
    "livecodebench": 0.20,
}
# correlated-error strength: probability a wrong answer is drawn from
# the shared confusion pool head rather than uniformly
DEFAULT_RETRIEVAL_BETA = 0.50   # quality shift per unit similarity
JUDGE_SCORE_NOISE = 0.45         # sd of the judge-visible quality signal
RETRIEVAL_SIM0 = 0.45           # similarity at which retrieval is neutral


def _task_rng(name: str, task_id: str, sample_idx: int,
              seed: int) -> np.random.Generator:
    h = hashlib.blake2b(
        f"{name}|{task_id}|{sample_idx}|{seed}".encode(),
        digest_size=8).digest()
    return np.random.default_rng(int.from_bytes(h, "little"))


@dataclass
class SyntheticBackend:
    """Deterministic calibrated model simulator."""

    profile: ModelProfile
    temperature_skill_penalty: float = 0.45   # sampling hurts a bit
    retrieval_beta: float = DEFAULT_RETRIEVAL_BETA

    @property
    def name(self) -> str:
        return self.profile.name

    def p_correct(self, task: Task, temperature: float,
                  retrieval_sim: Optional[float] = None) -> float:
        s = self.profile.skill + self.profile.bench_skill.get(
            task.benchmark, 0.0)
        if temperature > 0:
            s -= self.temperature_skill_penalty * temperature
        if retrieval_sim is not None:
            # §6.1: low-similarity exemplars inject noise
            s += self.retrieval_beta * (retrieval_sim - RETRIEVAL_SIM0)
        z = task.difficulty
        return float(1.0 / (1.0 + np.exp(-(s - z) * 1.6)))

    def _model_rng(self, task: Task, seed: int) -> np.random.Generator:
        """Sample-independent randomness: systematic per-(model, task)
        behaviour that temperature cannot shake (misconceptions)."""
        return _task_rng(self.name, task.task_id, -1, seed)

    def generate(self, task: Task, prompt: str, *, temperature: float,
                 sample_idx: int = 0, seed: int = 0,
                 retrieval_sim: Optional[float] = None) -> GenResult:
        rng = _task_rng(self.name, task.task_id, sample_idx, seed)
        mrng = self._model_rng(task, seed)
        trap_p = self.profile.trap_p * TRAP_BENCH_FACTOR.get(
            task.benchmark, 1.0)
        trapped = bool(mrng.random() < trap_p)
        p = self.p_correct(task, temperature, retrieval_sim)
        correct = (not trapped) and bool(rng.random() < p)
        if correct:
            semantic = task.gold
        else:
            if task.wrong_pool:
                # trapped: the model's own deterministic wrong answer;
                # otherwise a fresh temperature-jittered draw.
                draw = mrng if trapped else rng
                idx = draw.choice(len(task.wrong_pool),
                                  p=np.asarray(task.wrong_weights))
                semantic = task.wrong_pool[int(idx)]
            else:
                semantic = f"wrong_{self.name}_{task.task_id}" \
                    if trapped else f"wrong_{rng.integers(1 << 30)}"
        response = self._render(task, semantic, rng)
        latency = float(np.exp(
            np.log(self.profile.latency_mean_ms)
            + self.profile.latency_sigma * rng.standard_normal()))
        # quality signal a black-box judge extracts from the response:
        # correlated with correctness, noisy (JUDGE_SCORE_NOISE).
        score = float((1.0 if correct else 0.0)
                      + JUDGE_SCORE_NOISE * rng.standard_normal())
        return GenResult(response=response, semantic_answer=semantic,
                         cost=self.profile.cost_per_call,
                         latency_ms=latency, score=score)

    def _render(self, task: Task, semantic: str,
                rng: np.random.Generator) -> str:
        """Render the semantic answer as response text. Code responses
        are usually non-canonical (unique formatting nonce)."""
        if task.kind == "code" and rng.random() < CODE_NONCE_P:
            return f"def solution():  # v{rng.integers(1 << 20)}\n" \
                   f"    return {semantic}"
        if task.kind == "mcq":
            return f"Answer: {semantic}"
        if task.kind == "math":
            return f"After working through the steps, answer: {semantic}"
        return f"answer: {semantic}"


def paper_backends(
        retrieval_beta: float = DEFAULT_RETRIEVAL_BETA
) -> Dict[str, SyntheticBackend]:
    return {name: SyntheticBackend(profile, retrieval_beta=retrieval_beta)
            for name, profile in PAPER_MODELS.items()}
