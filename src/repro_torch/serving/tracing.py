"""Pluggable span tracing for the serving stack.

``NullTracer`` is the default: the runners hold ``tracer = None`` when
handed one (or nothing), so every instrumentation site reduces to a
single attribute check — exactly the ``serving/faults.py`` discipline.

``SpanTracer`` records the full lifecycle — admit → prefill-chunk →
probe-decode → route → ensemble-member launch → judge → retire, plus
every fault-path transition (requeue, retry, quarantine-degraded
route, shard re-placement, crash→restore) — as deterministic hashed
span records (``teamllm.spans``). Structure is a pure function of the
admission-ordered run; wall-clock stamps ride the non-hashed
``wall_time`` side channel. Parenting is implicit per stream: a
trace's row-lifecycle spans chain linearly, while per-lane decode
streams and per-member execution streams fork from the row stream and
chain launch-to-launch across megasteps and retries (``key=`` picks
the stream).

The tracer also carries the KV provenance map: prefix-cache owners are
recorded at insert (first writer in admission order — deterministic),
so a later hit can name its donor trace and PROV can materialize the
reuse as a ``wasDerivedFrom`` edge (``teamllm.prov``).

The port of ``repro/serving/tracing.py``: the same streams, span ids
and fields, so a run traced in either package has the same chain head.
On a card the ``acar_span_duration`` histogram the step loop observes
times host work, kernel enqueue included, not device work: launches
are asynchronous and the loop adds no synchronisation to time them.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

from repro_torch.teamllm.spans import SpanLog, span_record


class NullTracer:
    """Disarmed tracer: every hook is a no-op. The runners normalise
    ``NullTracer`` (or ``None``) to ``tracer = None`` so the serving
    loop pays one attribute check per site and nothing else."""

    armed = False

    def span(self, *a: Any, **k: Any) -> None:
        return None

    def kv_insert(self, *a: Any, **k: Any) -> None:
        return None

    def kv_source(self, *a: Any, **k: Any) -> None:
        return None

    def records(self) -> List[dict]:
        return []

    def flush(self) -> Optional[str]:
        return None


class SpanTracer:
    """JSONL span tracer. ``path=None`` keeps the chain in memory only
    (the harness reads ``records()`` directly); with a path, ``flush``
    writes an ``ArtifactStore``-verifiable hash-chained file.

    ``attribution`` controls whether the step loop schedules
    on-capacity leave-one-out recomputation for full-arena rows
    (span phase ``attribution``); it defaults on — the whole point of
    arming a tracer is the audit story.
    """

    armed = True

    def __init__(self, path: Union[str, Path, None] = None, *,
                 attribution: bool = True):
        self.path = Path(path) if path is not None else None
        self.log = SpanLog()
        self.attribution = attribution
        self._seq: Dict[str, int] = {}
        self._last: Dict[Tuple[str, Any], str] = {}
        # (model, prompt-ids hash) -> (owner trace, owner span): first
        # inserter in admission order owns the cached prefix pages
        self._prefix_owner: Dict[Tuple[str, str], Tuple[str, str]] = {}

    # -- spans ---------------------------------------------------------
    def span(self, phase: str, trace: str, tick: int, *,
             key: Any = None, parent: Optional[str] = None,
             wall: float = 0.0, **fields: Any) -> str:
        """Emit one span on ``trace``. ``key=None`` is the row
        lifecycle stream; any other key names a forked stream (a probe
        lane, a member execution) whose first span parents on the row
        stream and whose later spans chain within the fork."""
        seq = self._seq.get(trace, 0)
        self._seq[trace] = seq + 1
        sid = f"{trace}/{seq}"
        if parent is None:
            parent = self._last.get((trace, key))
            if parent is None and key is not None:
                parent = self._last.get((trace, None))
        self.log.append(
            span_record(phase, trace, sid, tick, parent=parent,
                        **fields),
            wall_time=wall or time.time())
        self._last[(trace, key)] = sid
        return sid

    # -- KV provenance -------------------------------------------------
    def kv_insert(self, model: str, ids_hash: str, trace: str,
                  span: str) -> None:
        """Record the owner of freshly inserted prefix-cache pages.
        ``setdefault`` keeps the first (admission-ordered) writer when
        duplicates race within one run — deterministic."""
        self._prefix_owner.setdefault((model, ids_hash), (trace, span))

    def kv_source(self, model: str, ids_hash: str
                  ) -> Optional[Tuple[str, str]]:
        """The (trace, span) whose prefill populated these cached
        pages, or None for an untracked entry (e.g. inserted before
        the tracer armed)."""
        return self._prefix_owner.get((model, ids_hash))

    # -- output --------------------------------------------------------
    @property
    def head(self) -> str:
        return self.log.head

    def records(self) -> List[dict]:
        return self.log.records()

    def flush(self) -> Optional[str]:
        """Persist the chain (one buffered write; see ``SpanLog``).
        Returns the chain head, or None when memory-only."""
        if self.path is None:
            return self.log.head
        return self.log.flush(self.path)
