"""Decision-trace schema (paper §3.1, Alg. 1 Phase 3).

A TraceRecord is the per-task auditable artifact: task identity, probe
samples, sigma, chosen mode, final answer, per-model responses, cost.
Wall-clock time lives in a separate non-hashed side channel so that the
hash chain is deterministic under re-execution (DESIGN.md §7.2).

Scheduling metadata (``schedule``: arrival tick, admission index,
batch id, probe-cache hit) rides the same non-hashed side channel: a
task routed through the continuous-batching scheduler must hash
identically to the same task routed through the sequential
orchestrator — batching is an execution strategy, not a semantic
input — while the queue/batch provenance stays fully auditable in the
persisted artifact row.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


def stable_json(obj: Any) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def content_hash(obj: Any) -> str:
    return hashlib.sha256(stable_json(obj).encode()).hexdigest()


def fault_record(kind: str, tick: int, **fields: Any) -> Dict[str, Any]:
    """A fault-path event as a plain hashable dict: injected faults,
    member retries/quarantines, degraded routes, shard losses, row
    aborts. Appended to the artifact chain (fully hashed — unlike
    ``TraceRecord``'s wall-time side channel, every field here is a
    deterministic function of the fault plan and admission order, so
    hashing it keeps degraded runs replay-verifiable)."""
    rec = {"event": "fault", "kind": str(kind), "tick": int(tick)}
    for k in sorted(fields):
        if fields[k] is not None:
            rec[k] = fields[k]
    return rec


@dataclass(frozen=True)
class ProbeSample:
    response: str
    answer: str               # EXTRACT(response)
    cost: float


@dataclass(frozen=True)
class ModelResponse:
    model: str
    response: str
    answer: str
    cost: float
    # judge-visible quality signal (self-rated confidence / verbosity /
    # formatting heuristics -- what a black-box judge actually sees).
    score: float = 0.0


@dataclass(frozen=True)
class TraceRecord:
    run_id: str
    task_id: str
    benchmark: str
    prompt_hash: str
    seed: int
    sigma: float              # in {0.0, 0.5, 1.0}
    mode: str                 # single_agent | arena_lite | full_arena
    probe_samples: Tuple[ProbeSample, ...]
    responses: Tuple[ModelResponse, ...]
    final_answer: str
    correct: Optional[bool]
    cost: float
    retrieval: Optional[Dict[str, Any]] = None
    logical_time: int = 0     # hashed (deterministic counter)
    wall_time: float = 0.0    # NOT hashed
    # scheduler provenance {arrival, admitted, batch_id, ...}; NOT
    # hashed — batched and sequential execution of the same task must
    # produce the same record hash
    schedule: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["probe_samples"] = [dataclasses.asdict(p)
                              for p in self.probe_samples]
        d["responses"] = [dataclasses.asdict(r) for r in self.responses]
        return d

    def hashed_view(self) -> Dict[str, Any]:
        d = self.to_dict()
        d.pop("wall_time", None)
        d.pop("schedule", None)
        return d

    def record_hash(self) -> str:
        return content_hash(self.hashed_view())
