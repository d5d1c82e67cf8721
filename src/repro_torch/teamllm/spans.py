"""Deterministic span records for provenance-grade observability.

A span is a plain hashable dict in the ``trace.fault_record`` mold:
its *structure* — phase, trace id, span id, parent link, virtual-clock
tick, and any decision fields — is a deterministic function of the
admission-ordered run, while wall-clock timestamps ride the artifact
store's non-hashed ``wall_time`` side channel. Two runs of the same
stream therefore produce byte-identical span record hashes and chain
heads, and arming a tracer cannot perturb the main decision trace
(``tests/harness/simulate.py --obs`` proves both properties).

Trace ids derive from ``(request_id, admission_index)`` — the same
stable per-task identity that seeds the sampling key streams — so a
task keeps one trace across requeues, retries, shard re-placement and
crash→recover. Span ids are per-trace ordinals: the k-th span a trace
emits is ``{trace}/{k}``, which makes parent/child links plain strings
inside hashed records.

``SpanLog`` keeps the hash chain in memory (same ``GENESIS`` /
``H(prev|record_hash)`` link as ``ArtifactStore``) and flushes to
byte-compatible JSONL in one buffered write, so an armed tracer pays
no per-span fsync; ``ArtifactStore(path)`` re-opens, verifies and
audits the flushed file unchanged.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

from repro_torch.teamllm.artifacts import GENESIS, ArtifactStore
from repro_torch.teamllm.trace import content_hash, stable_json


def make_trace_id(request_id: str, admission: int) -> str:
    """Stable trace identity: the request plus its global admission
    index (the pair that keys every sampling stream)."""
    return f"{request_id}#{int(admission)}"


def span_record(phase: str, trace: str, span: str, tick: int,
                parent: Optional[str] = None, **fields: Any
                ) -> Dict[str, Any]:
    """A hashable span event. ``tick`` is the deterministic virtual
    clock; non-None ``fields`` append in sorted order so the record —
    and its content hash — is reproducible."""
    rec: Dict[str, Any] = {
        "event": "span",
        "phase": str(phase),
        "trace": str(trace),
        "span": str(span),
        "tick": int(tick),
    }
    if parent is not None:
        rec["parent"] = str(parent)
    for k in sorted(fields):
        if fields[k] is not None:
            rec[k] = fields[k]
    return rec


class SpanLog:
    """In-memory hash-chained span buffer, ``ArtifactStore``-format on
    flush. The chain advances per append exactly like the store's, but
    the bytes hit disk once — an armed tracer must not put an fsync in
    the serving loop (``benchmarks/obs_bench.py`` gates the overhead).
    """

    def __init__(self):
        self.rows: List[Dict[str, Any]] = []
        self.head = GENESIS

    def __len__(self) -> int:
        return len(self.rows)

    def append(self, record: Dict[str, Any],
               wall_time: float = 0.0) -> str:
        """Chain and buffer one span record; returns the new head.
        ``wall_time`` is stored outside the hashed record, mirroring
        ``ArtifactStore._encode``'s side channel."""
        rh = content_hash(record)
        self.head = ArtifactStore._link(self.head, rh)
        self.rows.append({
            "record": record,
            "record_hash": rh,
            "chain_hash": self.head,
            "wall_time": float(wall_time),
        })
        return self.head

    def records(self) -> List[Dict[str, Any]]:
        return [row["record"] for row in self.rows]

    def flush(self, path: Union[str, Path]) -> str:
        """Write the buffered chain as ArtifactStore-compatible JSONL
        (one buffered write + fsync); returns the chain head.
        ``ArtifactStore(path)`` verifies the result byte-for-byte."""
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        lines = "".join(stable_json(row) + "\n" for row in self.rows)
        with p.open("w") as f:
            f.write(lines)
            f.flush()
            os.fsync(f.fileno())
        return self.head
