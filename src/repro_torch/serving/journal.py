"""Write-ahead step journal: the step loop's transition log, doubling
as its crash-recovery log.

The journal is itself a hash-chained ``ArtifactStore`` — the same
append-only, fsync'd, torn-tail-recovering substrate the decision
traces use — so a kill at any instant leaves a verifiable prefix of
the run's history. Events:

* ``admit``  — a row entered the active set (admission index,
  request id, tick);
* ``emit``   — one decode-group launch's per-lane deltas (admission
  index, lane tag, step counter, done bit, emitted token ids) — the
  megastep offsets and emitted tokens of the tick;
* ``retire`` — a row's full judge-visible outcome (sigma, mode, probe
  texts/answers, member answers, final answer, abort reason,
  timeline). This is the only event recovery *needs*;
* ``fault``  — an injected fault or its consequence (retry,
  quarantine, degraded route, shard loss, abort), mirrored from the
  runner's fault-event stream.

Recovery contract (``BatchedACAREngine.recover``): rows with a
durable ``retire`` event are restored verbatim; everything else —
in-flight rows included — re-executes *from scratch* with its
original global admission index. Because sampling key streams are
keyed by admission index (and per-row step counters), re-execution
emits bit-identical tokens, so a run killed at any tick and recovered
produces byte-identical record hashes and artifact-chain heads to an
uninterrupted run (``tests/harness/simulate.py --crash-at`` proves it
single-device and sharded). Re-prefilling in-flight rows instead of
teacher-forcing KV from journaled tokens is deliberate: prefill and
decode logits at the same position are not bit-identical (different
matmul shapes regroup the float reductions), so only a clean restart
preserves the hashes.

Appends are stamped with the virtual-clock tick as their (non-hashed)
wall time, so a journal file is a deterministic function of the run.

The port of ``repro/serving/journal.py``: a journal either package
writes loads in the other, to the same state and head.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Set, Union

from repro_torch.serving.faults import FaultInjector, SimulatedCrash
from repro_torch.teamllm.artifacts import ArtifactStore


@dataclass
class RecoveryState:
    """Parsed journal: everything ``recover()`` needs to resume."""
    retired: Dict[int, dict] = field(default_factory=dict)
    admitted: Set[int] = field(default_factory=set)
    faults: List[dict] = field(default_factory=list)
    records: int = 0
    torn_recovered: bool = False
    head: str = ""


class StepJournal:
    """Hash-chained write-ahead journal for one step-loop run."""

    def __init__(self, path: Union[str, Path],
                 injector: Optional[FaultInjector] = None):
        self.store = ArtifactStore(path)
        self.injector = injector

    @property
    def torn_recovered(self) -> bool:
        return self.store.torn_recovered

    @property
    def head(self) -> str:
        return self.store.head

    # -- event appends -------------------------------------------------
    def _append(self, event: Dict[str, Any], tick: int) -> str:
        if self.injector is not None:
            if self.injector.fire("artifact_append", tick) is not None:
                self._torn_append(event, tick)
        return self.store.append(event, wall_time=float(tick))

    def _torn_append(self, event: Dict[str, Any], tick: int) -> None:
        """Injected kill mid-append: write a strict prefix of the
        encoded line (no trailing newline) and die. The next open
        truncates the torn tail and the chain verifies at the previous
        head — the kill-mid-append regression path, end to end."""
        line, _ = self.store._encode(dict(event), wall_time=float(tick))
        with self.store.path.open("a") as f:
            f.write(line[:max(1, len(line) // 2)])
            f.flush()
            os.fsync(f.fileno())
        raise SimulatedCrash(
            f"injected kill mid-journal-append at tick {tick}")

    def admit(self, admission: int, request_id: str, tick: int) -> None:
        self._append({"ev": "admit", "adm": int(admission),
                      "request_id": request_id, "tick": int(tick)},
                     tick)

    def emit(self, tick: int, model: str, lanes: List[list]) -> None:
        """One decode-group launch: ``lanes`` rows are
        ``[admission, tag, steps_after, done, new_token_ids]``."""
        self._append({"ev": "emit", "tick": int(tick), "model": model,
                      "lanes": lanes}, tick)

    def retire(self, payload: Dict[str, Any], tick: int) -> None:
        self._append(dict(payload, ev="retire"), tick)

    def fault(self, rec: Dict[str, Any], tick: int) -> None:
        self._append(dict(rec, ev="fault"), tick)

    # -- recovery ------------------------------------------------------
    @staticmethod
    def load(path: Union[str, Path]) -> RecoveryState:
        """Open (recovering any torn tail), verify the chain, and fold
        the event stream into a ``RecoveryState``. A later ``retire``
        for an admission already seen wins — impossible in a single
        run, but harmless under journal concatenation."""
        store = ArtifactStore(path)
        state = RecoveryState(torn_recovered=store.torn_recovered,
                              head=store.head)
        for rec in store.records():
            state.records += 1
            ev = rec.get("ev")
            if ev == "admit":
                state.admitted.add(int(rec["adm"]))
            elif ev == "retire":
                state.retired[int(rec["adm"])] = rec
            elif ev == "fault":
                state.faults.append(rec)
        return state
