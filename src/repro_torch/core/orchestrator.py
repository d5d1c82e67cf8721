"""ACAR orchestrator — paper Algorithm 1 atop the TEAMLLM substrate.

Phase 1 (difficulty estimation): N probe samples -> EXTRACT -> sigma.
Phase 2 (adaptive routing): sigma -> {single_agent, arena_lite,
full_arena}; execute ensemble members accordingly; aggregate.
Phase 3 (logging): append the immutable TraceRecord.

Every run flows through the forward-only state machine and the
hash-chained artifact store. ``run_fixed_mode`` provides the paper's
baselines (Single-Model / Arena-2 / Arena-3) over the same substrate.

The per-task phases are module-level functions (``retrieve_exemplar``,
``probe_task``, ``execute_ensemble``, ``aggregate``, ``build_trace``)
so the continuous-batching scheduler (serving/scheduler.py) executes
the *same* code per task — the batched path differs only in how work
is grouped, which is what makes sequential<->batched equivalence
provable rather than aspirational.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.acar import ACARConfig
from repro_torch.core.backends import GenResult, ModelBackend, SyntheticBackend
from repro_torch.core.extract import extract
from repro_torch.core.judge import arena_verify, judge_select
from repro_torch.core.retrieval import ExperienceStore
from repro_torch.core.routing import (
    ARENA_LITE, FULL_ARENA, SINGLE_AGENT, decide, execution_mode,
    majority_vote, models_for_mode)
from repro_torch.core.sigma import sigma as sigma_fn
from repro_torch.data.tasks import Task
from repro_torch.teamllm.artifacts import ArtifactStore
from repro_torch.teamllm.fingerprint import render_prompt
from repro_torch.teamllm.state_machine import RunState, RunStateMachine
from repro_torch.teamllm.trace import ModelResponse, ProbeSample, TraceRecord

COORDINATION_COST = 0.0008      # per multi-model task (paper §4: the
#                                 overhead that makes Arena-2 == Arena-3)
COORDINATION_LATENCY_MS = 900.0


@dataclass
class TaskOutcome:
    trace: TraceRecord
    latency_ms: float
    semantic_answer: str
    correct: bool


# ----------------------------------------------------------------------
# per-task phases, shared between the sequential orchestrator and the
# continuous-batching scheduler
# ----------------------------------------------------------------------
def retrieve_exemplar(acfg: ACARConfig,
                      experience: Optional[ExperienceStore],
                      task: Task):
    """ACAR-UJ: query the experience store; returns
    (exemplar_text, similarity, meta) or (None, None, None)."""
    if not (acfg.retrieval_enabled and experience and len(experience)):
        return None, None, None
    res = experience.query(
        task.text, top_k=acfg.retrieval_top_k,
        threshold=acfg.retrieval_threshold)
    if not res:
        return None, None, {"hit": False}
    exp, sim = res[0]
    meta = {"hit": True, "similarity": sim,
            "exemplar_benchmark": exp.benchmark}
    return f"{exp.task_text} -> {exp.answer}", sim, meta


def backend_generate(backend: ModelBackend, task: Task, prompt: str,
                     temperature: float, sample_idx: int, seed: int,
                     retrieval_sim: Optional[float]) -> GenResult:
    kwargs = dict(temperature=temperature, sample_idx=sample_idx,
                  seed=seed)
    if isinstance(backend, SyntheticBackend):
        kwargs["retrieval_sim"] = retrieval_sim
    return backend.generate(task, prompt, **kwargs)


def probe_task(acfg: ACARConfig, probe: ModelBackend, task: Task,
               prompt: str, retrieval_sim: Optional[float]
               ) -> Tuple[List[ProbeSample], List[GenResult], float]:
    """Phase 1: N probe samples -> EXTRACT. Returns
    (probe_samples, raw results, probe latency = max over samples)."""
    probe_samples: List[ProbeSample] = []
    probe_results: List[GenResult] = []
    probe_latency = 0.0
    for i in range(acfg.n_probe_samples):
        r = backend_generate(probe, task, prompt,
                             acfg.probe_temperature, i, acfg.seed,
                             retrieval_sim)
        probe_results.append(r)
        probe_samples.append(ProbeSample(
            response=r.response,
            answer=extract(r.response, task.kind),
            cost=r.cost))
        probe_latency = max(probe_latency, r.latency_ms)
    return probe_samples, probe_results, probe_latency


def execute_ensemble(acfg: ACARConfig,
                     ensemble: Dict[str, ModelBackend],
                     executed_models: Sequence[str], task: Task,
                     prompt: str, retrieval_sim: Optional[float]
                     ) -> Tuple[List[ModelResponse],
                                Dict[str, GenResult], float]:
    """Phase 2 execution: run the routed ensemble members."""
    responses: List[ModelResponse] = []
    results: Dict[str, GenResult] = {}
    exec_latency = 0.0
    for name in executed_models:
        r = backend_generate(ensemble[name], task, prompt,
                             acfg.ensemble_temperature, 0, acfg.seed,
                             retrieval_sim)
        results[name] = r
        responses.append(ModelResponse(
            model=name, response=r.response,
            answer=extract(r.response, task.kind), cost=r.cost,
            score=r.score))
        exec_latency = max(exec_latency, r.latency_ms)
    return responses, results, exec_latency


def aggregate(task: Task, mode: str, probe_majority: str,
              probe_samples: Sequence[ProbeSample],
              probe_results: Sequence[GenResult],
              responses: Sequence[ModelResponse],
              results: Dict[str, GenResult]) -> Tuple[str, str]:
    """Returns (final extracted answer, semantic answer)."""
    def probe_semantic(ans: str) -> str:
        for p, r in zip(probe_samples, probe_results):
            if p.answer == ans:
                return r.semantic_answer
        return probe_results[0].semantic_answer

    def response_semantic(ans: str) -> str:
        for m in responses:
            if m.answer == ans:
                return results[m.model].semantic_answer
        return probe_semantic(ans)

    if mode == SINGLE_AGENT:
        return probe_majority, probe_semantic(probe_majority)
    if mode == ARENA_LITE:
        final = arena_verify(probe_majority, responses, task.task_id)
        if final == probe_majority:
            return final, probe_semantic(final)
        return final, response_semantic(final)
    final = judge_select(responses, task.task_id,
                         probe_answer=probe_majority)
    return final, response_semantic(final)


def task_cost_latency(probe_samples: Sequence[ProbeSample],
                      responses: Sequence[ModelResponse],
                      probe_latency: float,
                      exec_latency: float) -> Tuple[float, float]:
    cost = sum(p.cost for p in probe_samples) \
        + sum(r.cost for r in responses)
    latency = probe_latency + exec_latency
    if len(responses) > 1:
        cost += COORDINATION_COST
        latency += COORDINATION_LATENCY_MS
    return cost, latency


def build_trace(run_id: str, task: Task, prompt: str, seed: int,
                sig: float, mode: str,
                probe_samples: Sequence[ProbeSample],
                responses: Sequence[ModelResponse],
                final_answer: str, correct: bool, cost: float,
                ret_meta: Optional[Dict[str, Any]], logical_time: int,
                schedule: Optional[Dict[str, Any]] = None
                ) -> TraceRecord:
    return TraceRecord(
        run_id=run_id,
        task_id=task.task_id,
        benchmark=task.benchmark,
        prompt_hash=hashlib.sha256(prompt.encode()).hexdigest()[:16],
        seed=seed,
        sigma=sig,
        mode=mode,
        probe_samples=tuple(probe_samples),
        responses=tuple(responses),
        final_answer=final_answer,
        correct=correct,
        cost=cost,
        retrieval=ret_meta,
        logical_time=logical_time,
        schedule=schedule,
    )


class ACAROrchestrator:
    def __init__(self, acfg: ACARConfig, probe: ModelBackend,
                 ensemble: Dict[str, ModelBackend],
                 store: Optional[ArtifactStore] = None,
                 experience: Optional[ExperienceStore] = None,
                 run_id: str = "acar"):
        self.acfg = acfg
        self.probe = probe
        self.ensemble = ensemble
        self.ensemble_order = list(ensemble)
        self.store = store
        self.experience = experience
        self.run_id = run_id
        self._clock = 0

    # ------------------------------------------------------------------
    def run_task(self, task: Task) -> TaskOutcome:
        sm = RunStateMachine(f"{self.run_id}/{task.task_id}")
        sm.advance(RunState.EXECUTING)

        exemplar, sim, ret_meta = retrieve_exemplar(
            self.acfg, self.experience, task)
        prompt = render_prompt(task.text, exemplar or "")

        # Phase 1: probe sampling
        probe_samples, probe_results, probe_latency = probe_task(
            self.acfg, self.probe, task, prompt, sim)

        probe_answers = [p.answer for p in probe_samples]
        sig = sigma_fn(probe_answers)
        decision = decide(sig, probe_answers, self.ensemble_order,
                          self.acfg.arena_lite_size)
        mode = decision.mode

        # Phase 2: adaptive execution
        responses, results, exec_latency = execute_ensemble(
            self.acfg, self.ensemble, decision.executed_models, task,
            prompt, sim)

        final_answer, semantic = aggregate(
            task, mode, decision.probe_answer, probe_samples,
            probe_results, responses, results)

        sm.advance(RunState.VERIFYING)
        correct = semantic == task.gold
        cost, latency = task_cost_latency(
            probe_samples, responses, probe_latency, exec_latency)

        trace = build_trace(
            self.run_id, task, prompt, self.acfg.seed, sig, mode,
            probe_samples, responses, final_answer, correct, cost,
            ret_meta, self._clock)
        self._clock += 1
        if self.store is not None:
            self.store.append(trace)
        sm.advance(RunState.COMPLETED)
        return TaskOutcome(trace=trace, latency_ms=latency,
                           semantic_answer=semantic, correct=correct)

    # ------------------------------------------------------------------
    def run_suite(self, tasks: Sequence[Task]) -> List[TaskOutcome]:
        return [self.run_task(t) for t in tasks]


# ----------------------------------------------------------------------
# fixed-mode baselines (paper §4.3)
# ----------------------------------------------------------------------
def run_fixed_mode(tasks: Sequence[Task],
                   backends: Dict[str, ModelBackend],
                   members: Sequence[str],
                   store: Optional[ArtifactStore] = None,
                   seed: int = 0,
                   run_id: str = "baseline") -> List[TaskOutcome]:
    """Always execute exactly ``members`` (Single / Arena-2 / Arena-3)."""
    outcomes = []
    clock = 0
    for task in tasks:
        prompt = render_prompt(task.text)
        responses, results = [], {}
        latency = 0.0
        for name in members:
            r = backends[name].generate(
                task, prompt, temperature=0.0, sample_idx=0, seed=seed)
            results[name] = r
            responses.append(ModelResponse(
                model=name, response=r.response,
                answer=extract(r.response, task.kind), cost=r.cost,
                score=r.score))
            latency = max(latency, r.latency_ms)
        if len(responses) == 1:
            final = responses[0].answer
            semantic = results[members[0]].semantic_answer
        else:
            final = judge_select(responses, task.task_id)
            semantic = next(
                (results[m.model].semantic_answer for m in responses
                 if m.answer == final),
                results[members[0]].semantic_answer)
        cost = sum(m.cost for m in responses)
        if len(responses) > 1:
            cost += COORDINATION_COST
            latency += COORDINATION_LATENCY_MS
        correct = semantic == task.gold
        mode = {1: SINGLE_AGENT, 2: ARENA_LITE}.get(
            len(responses), FULL_ARENA)
        trace = TraceRecord(
            run_id=run_id, task_id=task.task_id, benchmark=task.benchmark,
            prompt_hash=hashlib.sha256(prompt.encode()).hexdigest()[:16],
            seed=seed, sigma=-1.0, mode=mode,
            probe_samples=(), responses=tuple(responses),
            final_answer=final, correct=correct, cost=cost,
            logical_time=clock)
        clock += 1
        if store is not None:
            store.append(trace)
        outcomes.append(TaskOutcome(trace=trace, latency_ms=latency,
                                    semantic_answer=semantic,
                                    correct=correct))
    return outcomes
