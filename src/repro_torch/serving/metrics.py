"""Prometheus-style metric registry (dependency-free).

Shared by the continuous-batching scheduler and the real-model engine's
queued serving path; rendering follows the Prometheus text exposition
format with deterministic ordering. Counters accumulate via ``inc``;
gauges (``set_gauge``) hold the last observed value — used for
per-wave occupancy readings like compaction bucket fill; histograms
(``observe``) bucket wall-clock samples — used for per-phase span
latencies (``acar_span_duration{phase}``) and decode-launch times.

A metric name owns one kind for the registry's lifetime: re-using a
counter name as a gauge (or any other cross-kind collision) raises
``ValueError`` instead of silently flipping the rendered TYPE and
corrupting both series.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

# Fault-tolerance metric names (one constant per exported series so
# the step loop, harness, and tests agree on spelling).
FAULTS_INJECTED = "acar_faults_injected_total"
MEMBER_RETRIES = "acar_member_retries_total"
MEMBER_QUARANTINED = "acar_member_quarantined"
ROUTES_DEGRADED = "acar_routes_degraded_total"
RECOVERY_ROWS_RESTORED = "acar_recovery_rows_restored_total"
ROW_DEADLINE_ABORTS = "acar_row_deadline_aborts_total"
STEP_REQUEUES = "acar_step_requeues_total"
# Work stealing (sharded step loop): member executions re-placed onto
# a roomier shard when the home shard's pool is page-tight, labelled
# {src, dst}.
SHARD_STEALS = "acar_shard_steals_total"

# Default histogram buckets: sub-millisecond host hooks up to
# multi-second device launches (seconds, Prometheus convention).
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class PromCounters:
    """Minimal Prometheus text-format counter/gauge/histogram
    registry."""

    def __init__(self):
        self._values: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                           float] = {}
        self._help: Dict[str, str] = {}
        self._types: Dict[str, str] = {}
        # histogram state, keyed like _values: per-series cumulative
        # bucket counts plus running sum/count
        self._buckets: Dict[str, Tuple[float, ...]] = {}
        self._hist: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                         List[float]] = {}

    @staticmethod
    def _key(name: str, labels: Dict[str, str]):
        return (name, tuple(sorted((k, str(v))
                                   for k, v in labels.items())))

    def _register(self, name: str, kind: str, help: str) -> None:
        """Claim ``name`` for ``kind``; a cross-kind re-use raises
        instead of silently flipping the rendered TYPE (the original
        ``set_gauge`` clobber bug). Later ``help=`` text lands when
        the first call passed none."""
        prev = self._types.setdefault(name, kind)
        if prev != kind:
            raise ValueError(
                f"metric {name!r} already registered as {prev}, "
                f"cannot re-use it as a {kind}")
        if help and name not in self._help:
            self._help[name] = help

    def inc(self, name: str, value: float = 1.0,
            help: str = "", **labels: str) -> None:
        self._register(name, "counter", help)
        key = self._key(name, labels)
        self._values[key] = self._values.get(key, 0.0) + value

    def set_gauge(self, name: str, value: float,
                  help: str = "", **labels: str) -> None:
        """Set a gauge to its latest observation (no accumulation)."""
        self._register(name, "gauge", help)
        self._values[self._key(name, labels)] = value

    def observe(self, name: str, value: float,
                buckets: Sequence[float] = DEFAULT_BUCKETS,
                help: str = "", **labels: str) -> None:
        """Record one histogram sample. The first ``observe`` for a
        name fixes its bucket bounds; a later call with different
        bounds raises (mixed-bound series render nonsense)."""
        self._register(name, "histogram", help)
        bounds = tuple(float(b) for b in buckets)
        prev = self._buckets.setdefault(name, bounds)
        if prev != bounds:
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{prev}, cannot re-use it with {bounds}")
        key = self._key(name, labels)
        state = self._hist.get(key)
        if state is None:
            # one slot per finite bucket + [sum, count]
            state = self._hist[key] = [0.0] * (len(bounds) + 2)
        for i, b in enumerate(bounds):
            if value <= b:
                state[i] += 1
        state[-2] += value
        state[-1] += 1

    def get(self, name: str, **labels: str) -> float:
        return self._values.get(self._key(name, labels), 0.0)

    def get_histogram(self, name: str, **labels: str
                      ) -> Tuple[float, float]:
        """(sum, count) for one histogram series (0, 0 if unseen)."""
        state = self._hist.get(self._key(name, labels))
        if state is None:
            return (0.0, 0.0)
        return (state[-2], state[-1])

    @staticmethod
    def _escape_label(value: str) -> str:
        """Escape a label value per the Prometheus text exposition
        format: backslash, double-quote and line-feed must appear as
        ``\\\\``, ``\\"`` and ``\\n`` inside the quoted value — a model
        name containing any of them otherwise renders invalid
        exposition text."""
        return (value.replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))

    @staticmethod
    def _escape_help(text: str) -> str:
        """HELP text escaping (backslash and line feed only, per the
        exposition format)."""
        return text.replace("\\", "\\\\").replace("\n", "\\n")

    @staticmethod
    def _fmt_le(bound: float) -> str:
        return f"{bound:g}"

    def _render_histogram(self, name: str, lines: List[str]) -> None:
        bounds = self._buckets[name]
        for (n, labels), state in sorted(self._hist.items()):
            if n != name:
                continue
            base = [f'{k}="{self._escape_label(v)}"'
                    for k, v in labels]
            for i, b in enumerate(bounds):
                lab = ",".join(base + [f'le="{self._fmt_le(b)}"'])
                lines.append(
                    f"{name}_bucket{{{lab}}} {state[i]:g}")
            lab = ",".join(base + ['le="+Inf"'])
            lines.append(f"{name}_bucket{{{lab}}} {state[-1]:g}")
            suffix = "{" + ",".join(base) + "}" if base else ""
            lines.append(f"{name}_sum{suffix} {state[-2]:g}")
            lines.append(f"{name}_count{suffix} {state[-1]:g}")

    def render(self) -> str:
        """Prometheus exposition text format, deterministically sorted."""
        lines: List[str] = []
        names = ({n for n, _ in self._values}
                 | {n for n, _ in self._hist})
        for name in sorted(names):
            if name in self._help:
                lines.append(f"# HELP {name} "
                             f"{self._escape_help(self._help[name])}")
            lines.append(
                f"# TYPE {name} {self._types.get(name, 'counter')}")
            if self._types.get(name) == "histogram":
                self._render_histogram(name, lines)
                continue
            for (n, labels), v in sorted(self._values.items()):
                if n != name:
                    continue
                if labels:
                    lab = ",".join(
                        f'{k}="{self._escape_label(v_)}"'
                        for k, v_ in labels)
                    lines.append(f"{name}{{{lab}}} {v:g}")
                else:
                    lines.append(f"{name} {v:g}")
        return "\n".join(lines) + ("\n" if lines else "")
