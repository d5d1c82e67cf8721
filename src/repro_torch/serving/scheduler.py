"""Continuous-batching ACAR scheduler and the step-level planner.

The port of ``repro/serving/scheduler.py``. The sequential orchestrator
(core/orchestrator.py) routes one task at a time; this scheduler serves
a continuous request stream:

1. **Admission** — requests enter an ``AdmissionQueue`` with logical
   arrival ticks and are grouped into micro-batches under a joint
   size/token/wait budget (serving/queue.py).
2. **Probe wave** — per micro-batch, the N-sample probe decode runs for
   every request (skipping prompts already in the probe cache), answers
   are interned to int32 ids, and sigma/route are computed over the
   whole wave at once with ``sigma_batch`` / ``route_batch`` (host
   tensors padded to the policy's batch size).
3. **Ensemble wave** — the routed ensemble members execute per request
   with per-mode masking (single_agent rows run nothing), and
   aggregation reuses the orchestrator's exact ``aggregate`` function.
4. **Pipelining** — the probe wave of micro-batch k+1 is prefetched on
   a worker thread while the ensemble wave of micro-batch k runs; a
   deterministic virtual clock accounts the modeled makespan of the
   pipeline vs the sequential path. The clock sums the backends'
   reported latencies: over ``TorchModelBackend``s, whose calls end in
   a device synchronise and share the card's default stream with the
   other thread, it says nothing about overlap on the card.

Equivalence guarantee: every per-task phase (retrieval, probe
generation, extraction, aggregation, cost accounting, trace
construction) is the *same code* the sequential orchestrator runs, and
all seeds derive from (model, task, sample, seed) — so the scheduler
produces identical modes, final answers, and record hashes, with
traces appended in admission order. Queue/batch provenance rides the
non-hashed ``schedule`` side channel of each TraceRecord.

Cost/latency accounting is exported as Prometheus-style counters
(``render_metrics``).

``StepPlanner`` is the per-tick policy of the step-level serving loop
(serving/step_loop.py). Shard placement is not ported yet.
"""
from __future__ import annotations

import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.acar import ACARConfig
from repro_torch.core.backends import GenResult, ModelBackend
from repro_torch.core.orchestrator import (
    TaskOutcome, aggregate, build_trace, execute_ensemble, probe_task,
    retrieve_exemplar, task_cost_latency)
from repro_torch.core.retrieval import ExperienceStore
from repro_torch.core.routing import (
    execution_mode, majority_vote, models_for_mode)
from repro_torch.core.sigma import (
    MODE_NAMES, route_batch, sigma as sigma_fn, sigma_batch)
from repro_torch.data.tasks import Task
from repro_torch.serving.compaction import (
    CompactionPlan, bucket_size, plan_compaction)
from repro_torch.serving.kv_pool import pages_for
from repro_torch.serving.metrics import PromCounters
from repro_torch.serving.queue import (
    AdmissionQueue, MicroBatch, MicroBatchPolicy, Request)
from repro_torch.teamllm.artifacts import ArtifactStore
from repro_torch.teamllm.fingerprint import render_prompt
from repro_torch.teamllm.state_machine import RunState, RunStateMachine
from repro_torch.teamllm.trace import ProbeSample


# ----------------------------------------------------------------------
# probe-result cache
# ----------------------------------------------------------------------
@dataclass
class _ProbeEntry:
    probe_samples: List[ProbeSample]
    probe_results: List[GenResult]
    probe_latency: float


class ProbeCache:
    """LRU cache of probe waves keyed by the full generation identity:
    (task_id, prompt, n_samples, temperature, seed). Deterministic
    backends make a hit byte-identical to recomputation, so cache reuse
    cannot perturb routing or trace hashes."""

    def __init__(self, capacity: int = 512):
        self.capacity = capacity
        self._data: Dict[Tuple, _ProbeEntry] = {}
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(task: Task, prompt: str, acfg: ACARConfig) -> Tuple:
        return (task.task_id, prompt, acfg.n_probe_samples,
                acfg.probe_temperature, acfg.seed)

    def lookup(self, key: Tuple) -> Optional[_ProbeEntry]:
        entry = self._data.get(key)
        if entry is not None:
            self.hits += 1
            self._data[key] = self._data.pop(key)    # refresh LRU slot
        else:
            self.misses += 1
        return entry

    def insert(self, key: Tuple, entry: _ProbeEntry) -> None:
        if self.capacity <= 0:
            return
        self._data[key] = entry
        while len(self._data) > self.capacity:
            self._data.pop(next(iter(self._data)))

    def __len__(self) -> int:
        return len(self._data)


# ----------------------------------------------------------------------
# step planner (step-level continuous batching policy)
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class StepPlanner:
    """Per-step scheduling policy for the step-level serving loop.

    * **admission** — a queued request joins the active set only when
      the fill-or-timeout trigger (``AdmissionQueue.ready``) has fired,
      the active-row cap has room, and the page budget is open: the
      row's worst-case page need (prompt pages + sample/decode tails)
      must fit in the pool's free pages net of what already-admitted
      rows may still allocate. Reservation-based admission is what
      makes mid-stream retirement safe: a row that got in can always
      finish.
    * **chunk sizing** — prompts prefill in fixed ``chunk_tokens``
      slices (the last chunk takes the remainder), bounding the
      per-step prefill working set regardless of prompt length.
    * **bucket selection** — each step's mixed decode/prefill groups
      pad to power-of-two row buckets (``bucket_size``), so a launch
      sees at most log2(rows)+1 shapes per (server, phase) instead of
      one per occupancy.
    * **megastep span** — decode groups fuse up to ``megastep`` ticks
      into one launch (``sampler.decode_megastep_rows``); lane state
      stays on the device between launches and only emitted token ids
      + done bits come back per megastep. Rows finishing mid-megastep
      burn <= K-1 masked steps (``StepStats.masked_decode_steps``).
      Sampling keys derive from (admission index, per-row step
      counter), so K is a pure performance knob — any value emits
      identical streams. With ``megastep_auto`` the span is capped by
      the group's *shortest* remaining budget, so no lane can overrun
      its budget mid-launch.
    """
    chunk_tokens: int = 8
    max_active_rows: int = 8
    megastep: int = 1
    megastep_auto: bool = False

    def __post_init__(self) -> None:
        if self.megastep < 1:
            raise ValueError(
                f"megastep must be >= 1, got {self.megastep}")

    def chunk_span(self, pos: int, prompt_len: int) -> int:
        """Tokens the next prefill step of a row at ``pos`` covers."""
        return min(self.chunk_tokens, prompt_len - pos)

    def chunk_count(self, prompt_len: int) -> int:
        """Prefill steps (virtual-clock units) a whole prompt costs."""
        return -(-prompt_len // self.chunk_tokens)

    def decode_bucket(self, rows: int, cap: Optional[int] = None) -> int:
        return bucket_size(rows, cap)

    def may_admit(self, active_rows: int, free_pages: int,
                  reserved_pages: int, row_need: int) -> bool:
        return (active_rows < self.max_active_rows
                and free_pages - reserved_pages >= row_need)

    def attribution_quota(self, tick_cost: int, pending: int) -> int:
        """On-capacity attribution budget for this tick: how many
        retired full-arena rows the step loop may recompute
        leave-one-out counterfactuals for (serving/step_loop.py drains
        its queue with it). The policy is strict idleness — a tick
        that launched any device program gets no budget, an idle tick
        drains everything pending. Attribution is host-side recompute
        over already-journaled answers, so the quota can never perturb
        the virtual clock or the decision trace; the remainder flushes
        after the stream drains."""
        return pending if tick_cost == 0 else 0


# ----------------------------------------------------------------------
# scheduler
# ----------------------------------------------------------------------
@dataclass
class _ProbedRequest:
    request: Request
    prompt: str
    retrieval_sim: Optional[float]
    ret_meta: Optional[Dict[str, Any]]
    probe_samples: List[ProbeSample]
    probe_results: List[GenResult]
    probe_latency: float
    cache_hit: bool
    sigma: float = 0.0
    mode: str = "single_agent"


@dataclass
class _ProbedBatch:
    batch: MicroBatch
    rows: List[_ProbedRequest]
    wave_latency_ms: float       # max over cache-missed rows
    # escalated-subset decode plan, computed on the (overlapped) probe
    # stage so the ensemble wave starts with its gather/bucket shapes
    # already known
    plan: Optional[CompactionPlan] = None
    # prompt pages held past the route decision for probe->ensemble
    # prefill seeding; released when this wave's ensemble completes
    kv_escalated_pages: int = 0


@dataclass
class SchedulerStats:
    tasks: int = 0
    batches: int = 0
    probe_cache_hits: int = 0
    probe_cache_misses: int = 0
    ensemble_calls_saved: int = 0
    total_cost: float = 0.0
    # compaction accounting (escalated-subset wave planning)
    escalated_rows: int = 0               # rows routed past single_agent
    full_arena_rows: int = 0              # rows routed to the full arena
    ensemble_decode_rows: int = 0         # compacted row-decodes issued
    ensemble_decode_rows_saved: int = 0   # full-batch masked rows elided
    probe_prefill_tokens: int = 0         # shared-prefix prefill tokens
    probe_prefill_tokens_saved: int = 0   # (N-1)x prompt tokens elided
    # paged KV-cache budget planning (virtual, page units): prompt
    # pages allocate once per cache-missed row (shared across the N
    # probe samples), sample pages free after the probe decode,
    # non-escalated rows free at the route decision, escalated rows'
    # prompt pages live until their ensemble wave finishes
    kv_pages_in_use: int = 0              # live pages, current
    kv_pages_highwater: int = 0           # peak live pages
    kv_pages_allocated: int = 0           # page allocations, total
    kv_prefill_tokens_reused: int = 0     # probe pages seeding ensemble
    # megastep accounting (step loop only; the wave path never masks):
    # decode ticks a lane sat masked because it finished mid-megastep
    masked_decode_steps: int = 0
    # deterministic virtual clock (the calibrated latency model)
    sequential_makespan_ms: float = 0.0   # sum of per-task latencies
    serial_batch_makespan_ms: float = 0.0  # batched, no overlap
    pipeline_makespan_ms: float = 0.0      # batched + stage overlap
    wall_ms: float = 0.0                   # host wall clock

    @property
    def speedup_vs_sequential(self) -> float:
        if self.pipeline_makespan_ms <= 0:
            return float("inf") if self.sequential_makespan_ms > 0 \
                else 1.0
        return self.sequential_makespan_ms / self.pipeline_makespan_ms

    @property
    def throughput_tasks_per_s(self) -> float:
        if self.pipeline_makespan_ms <= 0:
            return float("inf")
        return self.tasks / (self.pipeline_makespan_ms / 1e3)

    @property
    def ensemble_decode_row_reduction(self) -> float:
        """masked-path row-decodes / compacted row-decodes (>= 1)."""
        if self.ensemble_decode_rows <= 0:
            return float("inf") if self.ensemble_decode_rows_saved \
                else 1.0
        return (self.ensemble_decode_rows
                + self.ensemble_decode_rows_saved) \
            / self.ensemble_decode_rows

    @property
    def probe_prefill_reduction(self) -> float:
        """tiled-expansion prefill tokens / shared-prefix tokens."""
        if self.probe_prefill_tokens <= 0:
            return 1.0
        return (self.probe_prefill_tokens
                + self.probe_prefill_tokens_saved) \
            / self.probe_prefill_tokens


class ContinuousBatchingScheduler:
    """Continuous-batching, trace-equivalent ACAR serving scheduler."""

    def __init__(self, acfg: ACARConfig, probe: ModelBackend,
                 ensemble: Dict[str, ModelBackend],
                 store: Optional[ArtifactStore] = None,
                 experience: Optional[ExperienceStore] = None,
                 run_id: str = "acar",
                 policy: MicroBatchPolicy = MicroBatchPolicy(),
                 probe_cache_size: int = 512,
                 overlap: bool = True,
                 device_routing: bool = True,
                 kv_page_size: int = 8,
                 kv_decode_tokens: int = 8,
                 kv_layout: str = "dense",
                 kv_window: Optional[int] = None):
        self.acfg = acfg
        self.probe = probe
        self.ensemble = ensemble
        self.ensemble_order = list(ensemble)
        self.store = store
        self.experience = experience
        self.run_id = run_id
        self.policy = policy
        self.queue = AdmissionQueue(policy)
        self.cache = ProbeCache(probe_cache_size)
        self.overlap = overlap
        self.device_routing = device_routing
        # virtual paged-KV budget model (the engine measures the real
        # pool; the scheduler plans the same lifecycle in page units).
        # kv_layout prices the probe model's page layout: "dense" and
        # "quant" share the dense geometry (quant shrinks bytes per
        # page, not pages per row), "ring" caps a row's pages at the
        # window, "lanes" prices one recurrent-state lane per stream
        if kv_layout not in ("dense", "quant", "ring", "lanes"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        if kv_layout == "ring" and not kv_window:
            raise ValueError("kv_layout='ring' needs kv_window")
        self.kv_page_size = kv_page_size
        self.kv_decode_tokens = kv_decode_tokens
        self.kv_layout = kv_layout
        self.kv_window = kv_window
        self.metrics = PromCounters()
        self.stats = SchedulerStats()

    # -- admission -----------------------------------------------------
    def submit(self, task: Task,
               arrival_time: Optional[int] = None) -> Request:
        req = self.queue.submit(task, arrival_time)
        self.metrics.inc("acar_sched_requests_total",
                         help="requests admitted to the queue")
        self.metrics.inc("acar_sched_tokens_admitted_total",
                         req.est_tokens,
                         help="estimated prompt tokens admitted")
        return req

    def submit_many(self, tasks: Sequence[Task]) -> List[Request]:
        return [self.submit(t) for t in tasks]

    # -- probe wave ----------------------------------------------------
    def _probe_wave(self, batch: MicroBatch) -> _ProbedBatch:
        rows: List[_ProbedRequest] = []
        wave_latency = 0.0
        for req in batch.requests:
            task = req.task
            exemplar, sim, ret_meta = retrieve_exemplar(
                self.acfg, self.experience, task)
            prompt = render_prompt(task.text, exemplar or "")
            key = ProbeCache.key(task, prompt, self.acfg)
            entry = self.cache.lookup(key)
            hit = entry is not None
            if entry is None:
                samples, results, lat = probe_task(
                    self.acfg, self.probe, task, prompt, sim)
                entry = _ProbeEntry(samples, results, lat)
                self.cache.insert(key, entry)
                wave_latency = max(wave_latency, lat)
            rows.append(_ProbedRequest(
                request=req, prompt=prompt, retrieval_sim=sim,
                ret_meta=ret_meta, probe_samples=entry.probe_samples,
                probe_results=entry.probe_results,
                probe_latency=entry.probe_latency, cache_hit=hit))

        self._route_rows(rows)
        # wave planning: the escalated-subset gather/bucket shapes are
        # decided here, on the prefetch thread, so the ensemble wave of
        # batch k pipelines against the probe wave of batch k+1 with no
        # planning work left on the critical path
        modes_np = np.asarray(
            [MODE_NAMES.index(r.mode) for r in rows], np.int32)
        plan = plan_compaction(modes_np, len(self.ensemble_order),
                               self.acfg.arena_lite_size)
        return _ProbedBatch(batch=batch, rows=rows,
                            wave_latency_ms=wave_latency, plan=plan)

    def _route_rows(self, rows: List[_ProbedRequest]) -> None:
        """sigma + mode per row. The routing decision runs over the
        whole wave at once (host tensors padded to the policy's batch
        size); the recorded sigma uses the host Def. 1 value so trace
        hashes stay identical with sequential execution (float32 vs
        float64 rounding must not leak into the audit chain)."""
        if not rows:
            return
        answer_lists = [[p.answer for p in r.probe_samples]
                        for r in rows]
        for r, answers in zip(rows, answer_lists):
            r.sigma = sigma_fn(answers)
        if self.device_routing:
            n = self.acfg.n_probe_samples
            pad_b = self.policy.max_batch_size
            ids = np.zeros((pad_b, n), np.int32)
            for i, answers in enumerate(answer_lists):
                table: Dict[str, int] = {}
                for j, a in enumerate(answers):
                    ids[i, j] = table.setdefault(a, len(table))
            modes = route_batch(sigma_batch(torch.from_numpy(ids)))
            for i, r in enumerate(rows):
                r.mode = MODE_NAMES[int(modes[i])]
        else:
            for r in rows:
                r.mode = execution_mode(r.sigma)

    # -- ensemble wave -------------------------------------------------
    def _ensemble_wave(self, probed: _ProbedBatch
                       ) -> Tuple[List[TaskOutcome], float]:
        outcomes: List[TaskOutcome] = []
        wave_latency = 0.0
        self._account_compaction(probed)
        for row in probed.rows:
            req, task = row.request, row.request.task
            sm = RunStateMachine(f"{self.run_id}/{task.task_id}")
            sm.advance(RunState.EXECUTING)
            probe_majority = majority_vote(
                [p.answer for p in row.probe_samples])
            executed = models_for_mode(row.mode, self.ensemble_order,
                                       self.acfg.arena_lite_size)
            responses, results, exec_latency = execute_ensemble(
                self.acfg, self.ensemble, executed, task, row.prompt,
                row.retrieval_sim)
            final_answer, semantic = aggregate(
                task, row.mode, probe_majority, row.probe_samples,
                row.probe_results, responses, results)
            sm.advance(RunState.VERIFYING)
            correct = semantic == task.gold
            cost, latency = task_cost_latency(
                row.probe_samples, responses, row.probe_latency,
                exec_latency)
            task_exec_latency = latency - row.probe_latency
            wave_latency = max(wave_latency, task_exec_latency)

            trace = build_trace(
                self.run_id, task, row.prompt, self.acfg.seed,
                row.sigma, row.mode, row.probe_samples, responses,
                final_answer, correct, cost, row.ret_meta,
                logical_time=req.admission_index,
                schedule={
                    "arrival": req.arrival_time,
                    "admitted": req.admission_index,
                    "batch_id": req.batch_id,
                    "batch_formed_at": probed.batch.formed_at,
                    "probe_cache_hit": row.cache_hit,
                })
            if self.store is not None:
                self.store.append(trace)
            sm.advance(RunState.COMPLETED)
            outcomes.append(TaskOutcome(
                trace=trace, latency_ms=latency,
                semantic_answer=semantic, correct=correct))

            saved = len(self.ensemble_order) - len(executed)
            self.stats.ensemble_calls_saved += saved
            self.stats.total_cost += cost
            self.stats.sequential_makespan_ms += latency
            self.metrics.inc("acar_sched_mode_total", mode=row.mode,
                             help="tasks routed per execution mode")
            self.metrics.inc("acar_sched_cost_total", cost,
                             mode=row.mode,
                             help="accumulated cost per execution mode")
            self.metrics.inc("acar_sched_task_latency_ms_total",
                             latency, mode=row.mode,
                             help="accumulated per-task latency "
                                  "(sequential-equivalent) per mode")
            self.metrics.inc("acar_sched_ensemble_calls_saved_total",
                             saved,
                             help="ensemble calls avoided vs full arena")
            if row.cache_hit:
                self.metrics.inc("acar_sched_probe_cache_hits_total",
                                 help="probe waves served from cache")
            else:
                self.metrics.inc("acar_sched_probe_cache_misses_total",
                                 help="probe waves decoded")
        self._release_kv_pages(probed)
        return outcomes, wave_latency

    def _account_compaction(self, probed: _ProbedBatch) -> None:
        """Record the wave's escalated-subset decode plan: how many
        rows escalated, how many row-decodes the compacted sub-batches
        issue vs the full-batch masked path, the shape-bucket occupancy
        (one launch shape per power of two), and the
        shared-prefix probe prefill savings. Runs on the main thread —
        the probe wave may execute on the prefetch worker, so stats and
        metrics mutation stays out of ``_probe_wave``."""
        # shared-prefix probe: a cache-missed row prefills its prompt
        # once; the tiled (B*N) expansion would have prefilled it N
        # times
        n = self.acfg.n_probe_samples
        for row in probed.rows:
            if not row.cache_hit:
                est = row.request.est_tokens
                self.stats.probe_prefill_tokens += est
                self.stats.probe_prefill_tokens_saved += (n - 1) * est
                self.metrics.inc(
                    "acar_sched_probe_prefill_tokens_saved_total",
                    (n - 1) * est,
                    help="probe prefill tokens elided by shared-prefix "
                         "expansion")
        self._account_kv_pages(probed)
        plan = probed.plan
        if plan is None:
            return
        st = self.stats
        st.escalated_rows += plan.escalated_rows
        st.full_arena_rows += plan.full_arena_rows
        st.ensemble_decode_rows += plan.compacted_decode_rows
        st.ensemble_decode_rows_saved += plan.decode_rows_saved
        self.metrics.inc("acar_sched_escalated_rows_total",
                         plan.escalated_rows,
                         help="rows escalated past single_agent")
        self.metrics.inc("acar_sched_full_arena_rows_total",
                         plan.full_arena_rows,
                         help="rows escalated to the full arena")
        self.metrics.inc("acar_sched_ensemble_decode_rows_total",
                         plan.compacted_decode_rows,
                         help="row-decodes issued by compacted waves")
        self.metrics.inc(
            "acar_sched_ensemble_decode_rows_saved_total",
            plan.decode_rows_saved,
            help="row-decodes the masked full-batch path would have "
                 "issued but compaction elided")
        for mp in plan.members:
            if mp.bucket == 0:
                continue
            self.metrics.inc("acar_sched_bucket_waves_total",
                             bucket=str(mp.bucket),
                             help="member decode waves per shape bucket")
            self.metrics.set_gauge(
                "acar_sched_bucket_occupancy", mp.occupancy,
                bucket=str(mp.bucket),
                help="escalated-row fill of the last decode wave in "
                     "each shape bucket")

    def _row_page_plan(self, est_tokens: int) -> Tuple[int, int]:
        """(prompt pages, per-stream private pages) for one row under
        the planned layout — mirrors ``PagedKVServer.row_geometry``.
        Ring rows never hold more than the window's worth of pages
        however long the prompt runs (each stream rewrites its own
        capped snapshot); a lanes row is one fixed-size
        recurrent-state lane per stream regardless of length."""
        ps, e = self.kv_page_size, est_tokens
        if self.kv_layout == "ring":
            capped = pages_for(
                min(e + self.kv_decode_tokens, self.kv_window), ps)
            return capped, capped
        if self.kv_layout == "lanes":
            return 1, 1
        nbp = pages_for(e, ps)
        tail = pages_for(e + self.kv_decode_tokens, ps) - e // ps
        return nbp, tail

    def _account_kv_pages(self, probed: _ProbedBatch) -> None:
        """Virtual paged-KV lifecycle for one wave: prompt pages
        allocate once per cache-missed row (the N samples share them),
        sample-private pages free right after the probe decode,
        non-escalated rows free their prompt pages the moment the
        route resolves, and escalated rows keep theirs until the
        ensemble wave completes (``_release_kv_pages``) — seeding the
        prefill of any ensemble member that is the probe model, which
        is counted as reused prefill tokens."""
        n = self.acfg.n_probe_samples
        alloc = tails = esc_shared = resolved = reused = 0
        for row in probed.rows:
            if row.cache_hit:
                continue         # served from the probe cache: no KV
            e = row.request.est_tokens
            nbp, tail = self._row_page_plan(e)
            alloc += nbp + n * tail
            tails += n * tail
            if row.mode == "single_agent":
                resolved += nbp
            else:
                esc_shared += nbp
                executed = models_for_mode(
                    row.mode, self.ensemble_order,
                    self.acfg.arena_lite_size)
                if any(self.ensemble.get(m) is self.probe
                       for m in executed):
                    reused += e
        st = self.stats
        st.kv_pages_allocated += alloc
        st.kv_pages_in_use += alloc
        st.kv_pages_highwater = max(st.kv_pages_highwater,
                                    st.kv_pages_in_use)
        st.kv_pages_in_use -= tails + resolved
        st.kv_prefill_tokens_reused += reused
        probed.kv_escalated_pages = esc_shared
        if reused:
            self.metrics.inc(
                "acar_sched_kv_prefill_tokens_reused_total", reused,
                help="prompt prefill tokens ensemble members seed "
                     "from retained probe pages")
        self.metrics.set_gauge(
            "acar_sched_kv_pages_in_use", st.kv_pages_in_use,
            help="virtual KV pool pages live after wave planning")
        self.metrics.set_gauge(
            "acar_sched_kv_pages_highwater", st.kv_pages_highwater,
            help="virtual KV pool pages-in-use peak")

    def _release_kv_pages(self, probed: _ProbedBatch) -> None:
        self.stats.kv_pages_in_use -= probed.kv_escalated_pages
        probed.kv_escalated_pages = 0
        self.metrics.set_gauge(
            "acar_sched_kv_pages_in_use", self.stats.kv_pages_in_use,
            help="virtual KV pool pages live after wave planning")

    # -- main loop -----------------------------------------------------
    def run_until_idle(self) -> List[TaskOutcome]:
        """Drain the queue: form micro-batches, run the two-stage
        pipeline (probe wave of batch k+1 prefetched while the ensemble
        wave of batch k executes), emit traces in admission order."""
        t0 = time.perf_counter()
        batches = self.queue.drain_batches()
        outcomes: List[TaskOutcome] = []
        probe_end = 0.0          # virtual clock: probe stage frontier
        ens_end = 0.0            # virtual clock: ensemble stage frontier
        serial = 0.0

        executor: Optional[ThreadPoolExecutor] = None
        pending: Optional[Future] = None
        try:
            if self.overlap and len(batches) > 1:
                executor = ThreadPoolExecutor(max_workers=1)
            for k, batch in enumerate(batches):
                if pending is not None:
                    probed = pending.result()
                    pending = None
                else:
                    probed = self._probe_wave(batch)
                if executor is not None and k + 1 < len(batches):
                    pending = executor.submit(self._probe_wave,
                                              batches[k + 1])
                batch_outcomes, ens_latency = self._ensemble_wave(probed)
                outcomes.extend(batch_outcomes)

                # virtual two-stage pipeline bookkeeping: the probe
                # stage is serial with itself; an ensemble wave starts
                # once its probe wave AND the previous ensemble wave
                # are done
                probe_end = probe_end + probed.wave_latency_ms
                ens_end = max(probe_end, ens_end) + ens_latency
                serial += probed.wave_latency_ms + ens_latency

                self.stats.batches += 1
                self.stats.tasks += len(batch.requests)
                self.metrics.inc("acar_sched_batches_total",
                                 help="micro-batches executed")
                self.metrics.inc(
                    "acar_sched_probe_wave_ms_total",
                    probed.wave_latency_ms,
                    help="virtual probe-wave latency accumulated")
                self.metrics.inc(
                    "acar_sched_ensemble_wave_ms_total", ens_latency,
                    help="virtual ensemble-wave latency accumulated")
        finally:
            if pending is not None:
                pending.cancel()
            if executor is not None:
                executor.shutdown(wait=False)

        # each drain's virtual clock starts at 0, so successive drains
        # accumulate — keeping speedup/throughput honest for streaming
        # usage with repeated run_until_idle calls
        self.stats.serial_batch_makespan_ms += serial
        self.stats.pipeline_makespan_ms += ens_end
        self.stats.probe_cache_hits = self.cache.hits
        self.stats.probe_cache_misses = self.cache.misses
        self.stats.wall_ms += (time.perf_counter() - t0) * 1e3
        return outcomes

    def serve(self, tasks: Sequence[Task]) -> List[TaskOutcome]:
        """Convenience: submit every task, then drain."""
        self.submit_many(tasks)
        return self.run_until_idle()

    def render_metrics(self) -> str:
        return self.metrics.render()
