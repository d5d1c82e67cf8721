"""Deterministic fault injection for the serving stack.

ACAR's determinism contract — per-row sampling key streams keyed by
global admission index, hash-chained decision traces — makes failure
handling *testable*: if faults fire at seeded, reproducible
coordinates, then every retry, quarantine, degraded route and crash
recovery is itself a deterministic function of (task stream, fault
plan), and the equivalence harness can hold fault-tolerant execution
to the same bit-identical standard as every other execution strategy
(``tests/harness/simulate.py --crash-at`` / ``--faults``).

A ``FaultPlan`` is a tuple of ``FaultSpec`` coordinates; the
``FaultInjector`` consumes them one firing at a time. Sites:

* ``admit_alloc``     — ``PoolExhausted`` during admission-time page
                        allocation (the step loop requeues the row,
                        preserving its admission index);
* ``member_launch``   — transient failure of a member decode-group
                        launch (bounded virtual-clock retries with
                        exponential backoff; exhausting
                        ``max_retries`` quarantines the member);
* ``member_nan``      — a member decode launch emits non-finite
                        logits (immediate quarantine + route
                        degradation over the healthy members);
* ``shard_loss``      — a mesh shard dies: its page pool is
                        abandoned and its resident rows are re-placed
                        on surviving shards, restarting from prefill
                        (admission-indexed keys make the restart
                        bit-identical);
* ``artifact_append`` — process kill mid-journal-append (a torn final
                        line, exercising ``ArtifactStore``'s
                        truncate-and-reverify recovery);
* ``crash``           — process kill at a tick boundary (recovery
                        replays the write-ahead journal:
                        ``BatchedACAREngine.recover``).

Injected faults fire *before* the real device launch they displace,
so a retried or fault-free run emits bit-identical token streams —
fault handling is an execution strategy, not a semantic change.

The port of ``repro/serving/faults.py``: the same sites, plans and
firing order, so a plan fires at the same coordinates in both packages.
The port's step loop runs on one device, where ``shard_loss`` never
fires; it stays in ``SITES`` so that plans and ``generate`` equal the
reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

SITES = ("admit_alloc", "member_launch", "member_nan", "shard_loss",
         "artifact_append", "crash")


class SimulatedCrash(RuntimeError):
    """Injected process kill. Escapes the step loop uncaught — exactly
    like a real SIGKILL, nothing downstream of the raise runs — so the
    journal holds only what was already fsync'd."""


@dataclass(frozen=True)
class FaultSpec:
    """One fault coordinate: fire ``count`` times at the first
    opportunity at-or-after step-loop tick ``tick`` (the loop's
    iteration counter, not the virtual clock). ``model``/``shard``
    narrow the match; ``None`` is a wildcard."""
    tick: int
    site: str
    model: Optional[str] = None
    shard: Optional[int] = None
    count: int = 1

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}; one of {SITES}")
        if self.tick < 0:
            raise ValueError(f"fault tick must be >= 0, got {self.tick}")
        if self.count < 1:
            raise ValueError(
                f"fault count must be >= 1, got {self.count}")


@dataclass(frozen=True)
class FaultPlan:
    """A seeded, deterministic fault schedule plus the retry/SLO policy
    the step loop applies while the plan is active.

    * ``max_retries``   — member decode-group launch attempts beyond
      the first before the member is quarantined;
    * ``backoff_base``  — virtual-clock units the first retry waits;
      attempt ``k`` waits ``backoff_base << (k - 1)`` (exponential);
    * ``slo_deadline``  — optional per-row virtual-clock budget
      (retire within ``slo_deadline`` ticks of arrival or the row is
      aborted with a traced, null-answer retirement).
    """
    specs: Tuple[FaultSpec, ...] = ()
    seed: int = 0
    max_retries: int = 3
    backoff_base: int = 1
    slo_deadline: Optional[int] = None

    @classmethod
    def crash_at(cls, tick: int, *, torn: bool = False) -> "FaultPlan":
        """Kill the process at step-loop tick ``tick``; ``torn=True``
        kills mid-journal-append instead (a torn final line)."""
        site = "artifact_append" if torn else "crash"
        return cls(specs=(FaultSpec(tick=tick, site=site),))

    @classmethod
    def generate(cls, seed: int, *, n_faults: int = 4,
                 max_tick: int = 64,
                 models: Sequence[str] = (),
                 shards: int = 0,
                 sites: Optional[Sequence[str]] = None,
                 slo_deadline: Optional[int] = None) -> "FaultPlan":
        """Seeded random plan for chaos testing. Defaults exclude the
        terminal sites (``crash``/``artifact_append``) so a generated
        plan always drains; pass ``sites`` to include them."""
        rng = np.random.default_rng(seed)
        pool = list(sites) if sites is not None else [
            s for s in SITES if s not in ("crash", "artifact_append")]
        if not shards:
            pool = [s for s in pool if s != "shard_loss"]
        if not models:
            pool = [s for s in pool
                    if s not in ("member_launch", "member_nan")]
        specs: List[FaultSpec] = []
        for _ in range(n_faults):
            if not pool:
                break
            site = pool[int(rng.integers(len(pool)))]
            model = None
            shard = None
            if site in ("member_launch", "member_nan"):
                model = models[int(rng.integers(len(models)))]
            elif site == "shard_loss":
                shard = int(rng.integers(shards))
            specs.append(FaultSpec(
                tick=int(rng.integers(max_tick)), site=site,
                model=model, shard=shard))
        specs.sort(key=lambda sp: (sp.tick, sp.site, str(sp.model),
                                   -1 if sp.shard is None else sp.shard))
        return cls(specs=tuple(specs), seed=seed,
                   slo_deadline=slo_deadline)


class FaultInjector:
    """Consume-once firing engine for a ``FaultPlan``.

    ``fire(site, tick, ...)`` scans the plan in spec order and
    consumes the first spec matching (site, tick >= spec.tick,
    model/shard wildcards) with firings remaining. Everything is a
    pure function of the call sequence, so a replayed run fires every
    fault at identical coordinates — the property the chaos test and
    the degraded-fleet harness leg assert."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._remaining = [sp.count for sp in plan.specs]
        self.fired: List[dict] = []

    def fire(self, site: str, tick: int, *,
             model: Optional[str] = None,
             shard: Optional[int] = None) -> Optional[FaultSpec]:
        for i, sp in enumerate(self.plan.specs):
            if (self._remaining[i] <= 0 or sp.site != site
                    or tick < sp.tick):
                continue
            if sp.model is not None and sp.model != model:
                continue
            if sp.shard is not None and sp.shard != shard:
                continue
            self._remaining[i] -= 1
            self.fired.append({
                "site": site, "tick": int(tick), "model": model,
                "shard": shard, "spec_tick": sp.tick})
            return sp
        return None

    @property
    def exhausted(self) -> bool:
        """True once every planned firing has been consumed."""
        return all(r <= 0 for r in self._remaining)
