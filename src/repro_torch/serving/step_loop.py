"""Step-level continuous batching for the ACAR serving engine.

The port of ``repro/serving/step_loop.py::StepLoopRunner`` on one
device with the dense and quant page layouts. One logical tick advances a *mixed*
set of rows where each row is independently in

    prefill-chunk -> probe-decode -> route-pending -> ensemble-decode
                                                          -> done

Rows are admitted from ``AdmissionQueue.ready()`` the moment the page
budget opens (``StepPlanner.may_admit``), long prompts prefill in
fixed-size chunks appended to the paged KV pool
(``sampler.prefill_chunk_paged``; quant pages prefill one-shot), decodes of any phase mix into one
bucketed ``decode_megastep_rows`` launch per (server, temperature,
cache length) that runs up to ``StepPlanner.megastep`` ticks with the
lane state kept on the device, and a finished row retires — and frees
its pages — mid-stream, without waiting for its batch. The only arrays
pulled back per megastep are the (K, B) emitted-token-id and done-bit
stacks, which the host replays lane by lane.

Determinism: sampling uses per-row key streams keyed by admission index
(``sampler.sample_token_rows``), so a row's draws are independent of
which rows share its batch, and every host decision (grouping,
bucketing, admission, retirement) is a deterministic function of the
admission order. On the same params and stream the port makes the same
host decisions as the reference, tick for tick.

The virtual clock: one unit is one logical tick of device work (one
fused decode-tick iteration — a megastep launch charges its K fused
iterations — or one prefill chunk). Each model server is its own
executor, so a tick advances the clock by the *maximum* programs any
single server launched, while programs on the same server serialize.

Fault tolerance and observability ride the loop as the reference's do,
each hook one attribute check when unset: a ``FaultInjector`` fires
the plan's faults at loop-tick coordinates (requeue on admission-time
pool exhaustion, member launch retries with virtual-clock backoff,
quarantine and degraded routes, SLO-deadline aborts, a process kill);
a ``StepJournal`` logs admissions, decode emissions, retirements and
fault events, and a recovered run restores retired rows verbatim from
it; a ``SpanTracer`` records every lifecycle transition as a hashed
span and recomputes leave-one-out attribution for full-arena rows on
idle ticks. On one device a ``shard_loss`` never fires.

The ring and lane page layouts (``_run_one_shot_prefill_group``), the
dense-cache member fallback (``_dense_member``) and the sharded runner
(``ShardedStepLoopRunner``) are not ported yet; reaching them raises
``NotImplementedError``.
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.extract import extract, extract_batch
from repro_torch.core.routing import degrade_mode
from repro_torch.core.sigma import majority_vote_batch, sigma_batch
from repro_torch.data import tokenizer as tok
from repro_torch.sampling import prng
from repro_torch.sampling import sampler as S
from repro_torch.serving.faults import FaultInjector, SimulatedCrash
from repro_torch.serving.kv_pool import (
    PagedKVServer, PagePoolError, PoolExhausted, pages_for)
from repro_torch.serving.metrics import (
    FAULTS_INJECTED, MEMBER_QUARANTINED, MEMBER_RETRIES, PromCounters,
    RECOVERY_ROWS_RESTORED, ROUTES_DEGRADED, ROW_DEADLINE_ABORTS,
    STEP_REQUEUES)
from repro_torch.serving.queue import AdmissionQueue, Request
from repro_torch.serving.scheduler import StepPlanner
from repro_torch.teamllm.spans import make_trace_id
from repro_torch.teamllm.trace import fault_record

PHASES = ("prefill", "probe_decode", "route_pending",
          "ensemble_decode", "done")


# ----------------------------------------------------------------------
# per-row state
# ----------------------------------------------------------------------
@dataclass
class _Lane:
    """One decode stream: a probe sample or one member's answer."""
    block_table: np.ndarray            # (NB,) page ids
    row_key: np.ndarray                # (2,) uint32 sampling stream
    # (V,) pending next-token logits — on the device in the model's
    # native dtype (no host round-trip between ticks)
    logits: torch.Tensor
    tag: int = 0                       # deterministic within-row order
    steps: int = 0
    done: bool = False
    tokens: List[int] = field(default_factory=list)
    length: int = 0                    # live (pre-EOS) steps

    def harvest(self, max_new: int, pad_id: int) -> np.ndarray:
        out = np.full(max_new, pad_id, np.int32)
        out[:len(self.tokens)] = self.tokens
        return out


@dataclass
class _MemberExec:
    """One (row, member) ensemble execution."""
    member: int
    server: Optional[PagedKVServer]
    reuse: bool                        # seeded from the row's pages
    prefill_pos: int = 0
    from_cache: bool = False
    shared: Optional[np.ndarray] = None   # own prompt pages (non-reuse)
    tail: Optional[int] = None
    logits0: Optional[torch.Tensor] = None
    tails: Optional[np.ndarray] = None    # decode tail pages
    lane: Optional[_Lane] = None
    answer: Optional[str] = None


@dataclass
class _Row:
    request: Request
    ids: np.ndarray                    # (S,) prompt token ids
    phase: str = "prefill"
    # probe-server prompt pages
    shared: Optional[np.ndarray] = None
    tail: Optional[int] = None
    from_cache: bool = False
    prefill_pos: int = 0
    logits0: Optional[torch.Tensor] = None
    sample_tails: Optional[np.ndarray] = None     # (N, n_tail)
    lanes: List[_Lane] = field(default_factory=list)
    probe_texts: Optional[List[str]] = None
    probe_answers: Optional[List[str]] = None
    sigma: float = 0.0
    mode: int = 0
    members: List[_MemberExec] = field(default_factory=list)
    member_answers: Optional[List[Optional[str]]] = None
    final_answer: Optional[str] = None
    aborted: Optional[str] = None      # traced abort reason, or None
    admitted_at: int = 0
    retired_at: int = 0
    reserved: int = 0                  # probe-server pages still owed

    @property
    def admission(self) -> int:
        return self.request.admission_index

    @property
    def s(self) -> int:
        return int(self.ids.shape[0])


@dataclass
class StepStats:
    """Step-loop accounting. The virtual clock charges one unit per
    fused decode-tick iteration (a K-tick megastep launch costs K) or
    prefill chunk; ``launches`` counts actual device programs, and the
    ``decode_*`` transfer counters count host<->device arrays per
    megastep launch."""
    ticks: int = 0
    invocations: int = 0               # virtual-clock units charged
    launches: int = 0                  # device programs launched
    admissions: int = 0
    prefill_chunks: int = 0
    retired: int = 0
    # megastep accounting: ticks a lane sat masked because it finished
    # (or exhausted its budget) mid-megastep — the <=K-1 burn per row
    masked_decode_steps: int = 0
    decode_tokens: int = 0             # live tokens emitted by decode
    decode_h2d: int = 0                # host->device arrays per launch
    decode_d2h: int = 0                # device->host pulls per launch
    # fault-tolerance accounting
    restored: int = 0                  # rows restored from the journal
    requeues: int = 0                  # admissions requeued (alloc)
    retries: int = 0                   # member launch retries
    aborted: int = 0                   # rows retired with a null answer
    # per admission index: (arrival_tick, admitted_tick, retired_tick)
    timeline: Dict[int, Tuple[int, int, int]] = field(
        default_factory=dict)

    def latencies(self) -> np.ndarray:
        """Virtual-clock task latency (retire - arrival) per task."""
        return np.asarray([t[2] - t[0]
                           for t in self.timeline.values()], float)


class StepLoopRunner:
    """Executes the step-level loop over a ``BatchedACAREngine``'s
    models and paged-KV servers. One-shot: construct, ``run``."""

    def __init__(self, engine, queue: AdmissionQueue,
                 planner: StepPlanner,
                 metrics: Optional[PromCounters] = None, *,
                 faults: Optional[FaultInjector] = None,
                 journal=None,
                 recovered: Optional[Dict[int, dict]] = None,
                 tracer=None):
        self.eng = engine
        self.queue = queue
        self.planner = planner
        self.metrics = metrics if metrics is not None else PromCounters()
        self.stats = StepStats()
        self.acfg = engine.acfg
        self.n = engine.acfg.n_probe_samples
        self.max_new = engine.max_new_tokens
        self.megastep = planner.megastep
        self.base_key = prng.prng_key(engine.acfg.seed)
        # fault tolerance: every hook below is a single attribute
        # check when disabled, so the fault-free path pays nothing
        self.injector = faults
        self.journal = journal              # StepJournal, duck-typed
        self.recovered = dict(recovered) if recovered else None
        self.fault_events: List[dict] = []
        self._quarantined: set = set()
        # span tracing rides the same discipline: a disarmed or absent
        # tracer normalises to None, so every instrumentation site
        # below is one attribute check
        self.tracer = tracer if (tracer is not None
                                 and getattr(tracer, "armed", False)) \
            else None
        # escalated full-arena rows awaiting on-capacity
        # leave-one-out attribution (drained on idle ticks)
        self._attrib_queue: List[_Row] = []
        self._init_servers()
        self._reserved = 0                 # pages admitted rows may yet take
        self.active: List[_Row] = []
        self.done_rows: Dict[int, _Row] = {}
        self.now = 0
        self._routed_this_tick = 0

    def _init_servers(self) -> None:
        """Resolve the paged servers the loop allocates against."""
        engine = self.eng
        self.probe_srv: PagedKVServer = \
            engine._stepped_server(engine.probe)
        if self.probe_srv is None:
            raise ValueError(
                "run_stepped requires a paged-capable probe model "
                "(models.transformer.resolve_layout)")
        # one ensure_capacity_stream per distinct server; twin members
        # (same params as the probe) decode on the probe's server, so
        # its per-row worst case carries their seeded decode tails too
        self._servers: List[PagedKVServer] = [self.probe_srv]
        self._twins = 0
        for zm in engine.ensemble:
            srv = engine._stepped_server(zm)
            if srv is self.probe_srv and zm is not engine.probe:
                self._twins += 1
            elif srv is not None and srv not in self._servers:
                self._servers.append(srv)

    # -- placement hooks -----------------------------------------------
    def _probe_server(self, row: _Row) -> PagedKVServer:
        """The probe-model server hosting ``row``'s pages."""
        return self.probe_srv

    def _member_server(self, zm, row: _Row) -> Optional[PagedKVServer]:
        """The server a (row, member) execution allocates against."""
        return self.eng._stepped_server(zm)

    def _reuse_member(self, zm, row: _Row) -> bool:
        """Whether this member seeds its decode from the row's probe
        pages (twin params + compactable decode)."""
        return (self.eng._kv_reuse_member(zm, self.probe_srv)
                and self.eng._member_compactable(zm))

    def _group_key(self, srv) -> int:
        """Executor identity for launch grouping and the virtual
        clock."""
        return id(srv)

    # -- geometry ------------------------------------------------------
    def _geometry(self, srv, s: int):
        return srv.row_geometry(s, self.max_new)

    def _row_need(self, s: int) -> int:
        """Worst-case probe-server pages one row may still allocate."""
        return self.probe_srv.stream_row_pages(
            s, self.n + max(self._twins, 1), self.max_new)

    def _unreserve(self, row: _Row, pages: int) -> None:
        pages = min(pages, row.reserved)
        row.reserved -= pages
        self._reserved -= pages

    # -- span tracing --------------------------------------------------
    def _trace_id(self, row: _Row) -> str:
        return make_trace_id(row.request.request_id, row.admission)

    def _kv_reuse_span(self, model: str, row: _Row, kind: str,
                       key=None) -> None:
        """PROV raw material: a ``wasDerivedFrom`` edge — KV state
        seeded from retained pages instead of recomputation.
        ``kind='prefix'`` names the donor trace whose prefill
        populated the cache entry (recorded at insert, first writer in
        admission order); ``kind='probe'`` marks a member decode
        seeded from the row's own probe prompt pages."""
        trace = self._trace_id(row)
        if kind == "probe":
            src, src_span = trace, None
        else:
            owner = self.tracer.kv_source(
                model, hashlib.sha256(row.ids.tobytes()).hexdigest())
            src = owner[0] if owner else None
            src_span = owner[1] if owner else None
        self.tracer.span("kv_reuse", trace, self.now, key=key,
                         kind=kind, model=model, source=src,
                         source_span=src_span)

    def _observe_span(self, phase: str, t0: float) -> None:
        """Host wall seconds of one traced phase. On a card this is
        host work and kernel enqueue, not device time."""
        self.metrics.observe(
            "acar_span_duration", time.perf_counter() - t0, phase=phase,
            help="host wall seconds per traced lifecycle phase")

    # -- fault handling ------------------------------------------------
    def _fired(self, site: str, **match) -> bool:
        """Did an injected fault fire at this site this step? Every
        firing is counted and traced (and journaled when a journal is
        attached). Fault coordinates match on the loop's iteration
        counter, so a replayed run fires identically."""
        if self.injector is None:
            return False
        if self.injector.fire(site, self.stats.ticks, **match) is None:
            return False
        self.metrics.inc(FAULTS_INJECTED, site=site,
                         help="injected faults fired, by site")
        self._trace_fault("injected", site=site, **match)
        return True

    def _trace_fault(self, kind: str, **fields) -> None:
        """Record a fault-path event: collected on the runner (the
        engine returns them as ``QueuedServeResult.faults``) and
        mirrored into the journal."""
        rec = fault_record(kind, self.now, **fields)
        self.fault_events.append(rec)
        if self.journal is not None:
            self.journal.fault(rec, self.now)

    def _fault_tick(self) -> None:
        """Tick-boundary fault checks: process kill and per-row SLO
        deadlines (a shard loss has no shard to take on one device).
        Runs right after admission so a crash tick is a clean
        transaction boundary."""
        if self._fired("crash"):
            raise SimulatedCrash(
                f"injected process kill at step-loop tick "
                f"{self.stats.ticks}")
        ddl = self.injector.plan.slo_deadline
        if ddl is not None:
            for row in list(self.active):
                if self.now - row.request.arrival_time > ddl:
                    self._abort_row(row, "slo_deadline")

    def _member_fault_gate(self, items) -> int:
        """Pre-launch injected faults for one member decode group:
        bounded retries with exponential virtual-clock backoff, then
        quarantine on exhaustion or injected NaN logits. Faults fire
        *before* the real launch (which has no side effects yet), so a
        retried group re-launches with the same tokens. Returns the
        backoff penalty in virtual-clock units, or -1 when the group
        was quarantined (the launch must be skipped)."""
        if not all(it[2].tag >= 100 for it in items):
            return 0                   # probe lanes mixed in: not a
        model = items[0][0].stats.model  # member group
        plan = self.injector.plan
        penalty = 0
        retries = 0
        while self._fired("member_launch", model=model):
            retries += 1
            self.stats.retries += 1
            self.metrics.inc(MEMBER_RETRIES, model=model,
                             help="member decode-group launch retries")
            penalty += plan.backoff_base << (retries - 1)
            self._trace_fault("member_retry", model=model,
                              attempt=retries)
            if self.tracer is not None:
                for it in items:
                    self.tracer.span(
                        "member_retry", self._trace_id(it[1]),
                        self.now, key=("m", it[2].tag - 100),
                        model=model, attempt=retries)
            if retries > plan.max_retries:
                self._quarantine_group(items, model,
                                       "launch_retries_exhausted")
                return -1
        if self._fired("member_nan", model=model):
            self._quarantine_group(items, model, "nan_logits")
            return -1
        return penalty

    def _quarantine_group(self, items, model: str, reason: str) -> None:
        """Quarantine every ensemble member decoding in this group and
        degrade all in-flight routes over the remaining healthy
        members. Completed answers are kept; only unanswered
        executions are dropped."""
        members = sorted({it[2].tag - 100 for it in items})
        for mi in members:
            if mi in self._quarantined:
                continue
            self._quarantined.add(mi)
            self.metrics.set_gauge(
                MEMBER_QUARANTINED, 1.0,
                model=self.eng.ensemble[mi].name,
                help="1 while an ensemble member is quarantined")
            self._trace_fault("member_quarantined", member=mi,
                              model=self.eng.ensemble[mi].name,
                              reason=reason)
            if self.tracer is not None:
                # fleet-scoped span: quarantine is not row state
                self.tracer.span(
                    "member_quarantined", "fleet", self.now,
                    member=mi, model=self.eng.ensemble[mi].name,
                    reason=reason)
        for row in list(self.active):
            if row.phase == "ensemble_decode":
                self._degrade_row(row)

    def _apply_degraded_mode(self, row: _Row) -> None:
        """Degrade a row's route over the healthy members (the
        routing ladder in ``core.routing.degrade_mode``); a row left
        with no members falls back to the probe consensus."""
        healthy = [mi not in self._quarantined
                   for mi in range(len(self.eng.ensemble))]
        new_mode = degrade_mode(row.mode, healthy,
                                self.acfg.arena_lite_size)
        if row.phase == "ensemble_decode" and not row.members:
            new_mode = 0
        if new_mode != row.mode:
            self.metrics.inc(
                ROUTES_DEGRADED, 1.0,
                help="routes degraded over quarantined members",
                **{"from": str(row.mode), "to": str(new_mode)})
            self._trace_fault("route_degraded",
                              admission=row.admission,
                              **{"from": row.mode, "to": new_mode})
            if self.tracer is not None:
                self.tracer.span("route_degraded",
                                 self._trace_id(row), self.now,
                                 **{"from": row.mode, "to": new_mode})
            row.mode = new_mode

    def _degrade_row(self, row: _Row) -> None:
        """Drop a row's unanswered executions on quarantined members
        and re-judge under the degraded mode."""
        dropped = [mx for mx in row.members
                   if mx.member in self._quarantined
                   and mx.answer is None]
        if not dropped:
            return
        for mx in dropped:
            self._abort_member_exec(row, mx)
            row.members.remove(mx)
        self._apply_degraded_mode(row)
        if not row.members:
            # every member dropped: the probe consensus is final
            self._release_prompt(self._probe_server(row), row)
            self._judge(row)
            self._retire(row)
        else:
            self._finish_members(row)

    def _abort_member_exec(self, row: _Row, mx: _MemberExec) -> None:
        """Release one (row, member) execution's pages mid-flight. The
        lane object may still sit in this tick's precomputed decode
        groups; marking it done masks it in any launch that follows."""
        srv = self._probe_server(row) if mx.reuse else mx.server
        if mx.lane is not None:
            mx.lane.done = True
            mx.lane = None
        if mx.tails is not None:
            srv.pool.release(mx.tails)
            mx.tails = None
        if not mx.reuse and mx.shared is not None:
            self._release_prompt(srv, mx)
        if srv is not None:
            srv._sample_usage()

    def _abort_row(self, row: _Row, reason: str) -> None:
        """Retire a row with a null answer and a traced abort reason,
        releasing everything it holds (SLO deadline)."""
        srv = self._probe_server(row)
        if row.sample_tails is not None:
            srv.pool.release(row.sample_tails.reshape(-1))
            row.sample_tails = None
        for lane in row.lanes:
            lane.done = True
        row.lanes = []
        for mx in row.members:
            if mx.answer is None:
                self._abort_member_exec(row, mx)
        row.members = []
        self._release_prompt(srv, row)
        row.probe_texts = row.probe_texts or []
        row.probe_answers = row.probe_answers or []
        if row.member_answers is None:
            row.member_answers = [None] * len(self.eng.ensemble)
        row.final_answer = None
        row.aborted = reason
        self.stats.aborted += 1
        if reason == "slo_deadline":
            self.metrics.inc(ROW_DEADLINE_ABORTS,
                             help="rows aborted past their SLO "
                                  "deadline")
        self._trace_fault("row_aborted", admission=row.admission,
                          reason=reason)
        if self.tracer is not None:
            self.tracer.span("abort", self._trace_id(row), self.now,
                             reason=reason)
        self._retire(row)

    def _rollback_admission(self, row: _Row) -> None:
        """Undo a partially-allocated admission (``PoolExhausted``
        mid ``_begin_prefill``): release whatever was retained or
        allocated and return the row's page reservation."""
        srv = self._probe_server(row)
        if row.sample_tails is not None:
            srv.pool.release(row.sample_tails.reshape(-1))
            row.sample_tails = None
        row.lanes = []
        self._release_prompt(srv, row)
        row.from_cache = False
        row.prefill_pos = 0
        row.logits0 = None
        row.phase = "prefill"
        self._unreserve(row, row.reserved)
        self.stats.timeline.pop(row.admission, None)

    def _try_begin_prefill(self, row: _Row) -> bool:
        """Admission-time allocation with ``PoolExhausted`` rollback:
        the row is requeued at the head of the queue *keeping its
        admission index*, so its sampling key streams — and therefore
        its tokens — are unchanged when it re-admits."""
        try:
            if self._fired("admit_alloc"):
                raise PoolExhausted(
                    "injected admission-time pool exhaustion")
            self._begin_prefill(row)
            return True
        except PoolExhausted:
            self._rollback_admission(row)
            self.queue.requeue(row.request)
            self.stats.requeues += 1
            self.metrics.inc(
                STEP_REQUEUES,
                help="admissions requeued on PoolExhausted")
            self._trace_fault("requeued", admission=row.admission)
            if self.tracer is not None:
                # the re-admission's admit span parents on this one:
                # one trace spans the requeue
                self.tracer.span("requeued", self._trace_id(row),
                                 self.now)
            return False

    def _restore_head(self) -> bool:
        """Crash recovery: restore the queue head verbatim from its
        journaled retirement. Retired rows are *not* a prefix of the
        admission order (later rows retire first all the time), so
        this is checked per-head inside the admission loop, bypassing
        the ready()/arrival gating — restoration is instantaneous
        host work."""
        head = self.queue.peek()
        idx = head.admission_index
        if idx is None:
            idx = self.queue.next_admission_index
        rec = self.recovered.get(idx)
        if rec is None:
            return False
        del self.recovered[idx]
        req = self.queue.pop()
        row = _Row(request=req, ids=np.zeros(0, np.int32),
                   phase="done", sigma=float(rec["sigma"]),
                   mode=int(rec["mode"]),
                   probe_texts=list(rec["probe_texts"]),
                   probe_answers=list(rec["probe_answers"]),
                   member_answers=list(rec["member_answers"]),
                   final_answer=rec["final_answer"],
                   aborted=rec.get("aborted"))
        self.stats.timeline[idx] = tuple(rec["timeline"])
        self.stats.retired += 1
        self.stats.restored += 1
        self.done_rows[idx] = row
        self.metrics.inc(
            RECOVERY_ROWS_RESTORED,
            help="rows restored verbatim from the step journal")
        if self.tracer is not None:
            # span continuity across crash->recover: the restored
            # trace re-materialises from its journaled retirement (a
            # restore span parenting a retire span), so every admitted
            # task still ends in a retire span after a journal replay
            trace = self._trace_id(row)
            self.tracer.span("restore", trace, self.now,
                             task_id=req.task.task_id,
                             sigma=row.sigma, mode=row.mode)
            self.tracer.span("retire", trace, self.now,
                             task_id=req.task.task_id,
                             final_answer=row.final_answer,
                             sigma=row.sigma, mode=row.mode,
                             aborted=row.aborted, restored=1)
            if (getattr(self.tracer, "attribution", False)
                    and row.mode >= 2 and row.aborted is None
                    and row.member_answers is not None):
                self._attrib_queue.append(row)
        return True

    # -- admission -----------------------------------------------------
    def _admit_ready(self) -> None:
        while len(self.queue):
            if self.recovered and self._restore_head():
                continue
            if not self.queue.ready(self.now):
                break
            head = self.queue.peek()
            if head.arrival_time > self.now:
                break
            ids = tok.encode_aligned([head.task.text])[0]
            s = int(ids.shape[0])
            try:
                self.probe_srv.ensure_capacity_stream(
                    self.planner.max_active_rows, s,
                    self.n + max(self._twins, 1), self.max_new)
                for srv in self._servers[1:]:
                    srv.ensure_capacity_stream(
                        self.planner.max_active_rows, s, 1,
                        self.max_new)
            except PagePoolError:
                # a longer prompt needs a bigger pool, which can only
                # rebuild while no pages are held: defer admission
                # until the active rows drain instead of failing the
                # stream (progress is guaranteed — retirement frees
                # pages every tick, and an idle pool always rebuilds)
                if self.active:
                    break
                raise
            if not self.planner.may_admit(
                    len(self.active), self.probe_srv.pool.free_pages,
                    self._reserved, self._row_need(s)):
                break
            req = self.queue.pop()
            row = _Row(request=req, ids=ids, admitted_at=self.now,
                       reserved=self._row_need(s))
            self._reserved += row.reserved
            self.stats.timeline[row.admission] = (
                req.arrival_time, self.now, -1)
            if self.tracer is not None:
                self.tracer.span("admit", self._trace_id(row),
                                 self.now, prompt_tokens=s,
                                 arrival=req.arrival_time)
            if not self._try_begin_prefill(row):
                break
            self.active.append(row)
            self.stats.admissions += 1
            self.metrics.inc("acar_step_admissions_total",
                             help="rows admitted into the step loop")
            if self.journal is not None:
                self.journal.admit(row.admission, req.request_id,
                                   self.now)

    def _begin_prefill(self, row: _Row) -> None:
        srv = self._probe_server(row)
        s = row.s
        g = self._geometry(srv, s)
        entry = srv._prefix_lookup(row.ids.tobytes())
        if entry is not None:
            srv.pool.retain(entry.shared)
            if entry.tail is not None:
                srv.pool.retain([entry.tail])
            row.shared = entry.shared.copy()
            row.tail = entry.tail
            row.logits0 = entry.logits0.clone()
            row.from_cache = True
            row.prefill_pos = s
            srv.stats.prefill_tokens_reused_prefix += s
            if self.tracer is not None:
                self._kv_reuse_span(srv.stats.model, row, "prefix")
            self._unreserve(row, g.nbp)
            self._begin_probe_decode(row)
            return
        pages = srv._alloc_retry(g.nbp)
        row.shared = pages[:g.n_shared]
        row.tail = int(pages[g.n_shared]) if g.tail_tokens else None
        self._unreserve(row, g.nbp)

    def _begin_probe_decode(self, row: _Row) -> None:
        srv = self._probe_server(row)
        s = row.s
        g = self._geometry(srv, s)
        row.sample_tails = srv._alloc_retry(
            self.n * g.n_tail).reshape(self.n, g.n_tail)
        self._unreserve(row, self.n * g.n_tail)
        keys = S.probe_row_keys(self.base_key, [row.admission], self.n)
        for j in range(self.n):
            table = np.empty(g.nb, np.int32)
            if g.n_shared:
                table[:g.n_shared] = row.shared
            table[g.n_shared:] = row.sample_tails[j]
            row.lanes.append(_Lane(block_table=table, row_key=keys[j],
                                   logits=row.logits0.clone(), tag=j))
        if g.tail_tokens:
            self._fork(srv, [row.tail] * self.n,
                       row.sample_tails[:, 0].tolist())
            srv.stats.cow_forks += self.n
        row.phase = "probe_decode"
        srv._sample_usage()

    # -- page plumbing -------------------------------------------------
    def _fork(self, srv: PagedKVServer, src: Sequence[int],
              dst: Sequence[int]) -> None:
        S.fork_pages(srv.pages, src, dst)

    def _release_prompt(self, srv: PagedKVServer, row_or_mx) -> None:
        if row_or_mx.shared is not None:
            srv.pool.release(row_or_mx.shared)
            if row_or_mx.tail is not None:
                srv.pool.release([row_or_mx.tail])
            row_or_mx.shared = None
            row_or_mx.tail = None
        srv._sample_usage()

    def _device_array(self, srv: PagedKVServer, a: np.ndarray
                      ) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(srv.device)

    # -- prefill step --------------------------------------------------
    def _prefill_groups(self):
        """Group rows/member-execs needing prefill work by
        (server, chunk_len, prompt_len). Per-row start offsets are
        arguments of the chunk launch, so rows at different prefill
        depths — freshly admitted rows next to members that escalated
        ticks ago — share one launch."""
        groups: Dict[tuple, list] = {}
        for row in self.active:
            if row.phase == "prefill":
                srv = self._probe_server(row)
                c = self.planner.chunk_span(row.prefill_pos, row.s) \
                    if srv.chunked else -1
                key = (self._group_key(srv), c, row.s)
                groups.setdefault(key, []).append((srv, row, None))
            elif row.phase == "ensemble_decode":
                for mx in row.members:
                    if (mx.answer is None and not mx.reuse
                            and mx.lane is None and not mx.from_cache
                            and mx.prefill_pos < row.s):
                        c = self.planner.chunk_span(
                            mx.prefill_pos, row.s) \
                            if mx.server.chunked else -1
                        key = (self._group_key(mx.server), c, row.s)
                        groups.setdefault(key, []).append(
                            (mx.server, row, mx))
        return groups

    def _run_prefill_group(self, key, items) -> int:
        _, c, s = key
        if c < 0:
            return self._run_one_shot_prefill_group(key, items)
        t0 = time.perf_counter() if self.tracer is not None else 0.0
        srv = items[0][0]
        ps = srv.page_size
        nbp = pages_for(s, ps)
        rows = sorted(items, key=lambda it: it[1].admission)
        bucket = self.planner.decode_bucket(len(rows))
        tokens = np.empty((bucket, c), np.int32)
        tables = np.empty((bucket, nbp), np.int32)
        starts = np.zeros(bucket, np.int32)
        for i in range(bucket):
            srv_i, row, mx = rows[min(i, len(rows) - 1)]
            target = mx if mx is not None else row
            starts[i] = target.prefill_pos
            tokens[i] = row.ids[starts[i]:starts[i] + c]
            if i < len(rows):
                tables[i, :target.shared.size] = target.shared
                if target.tail is not None:
                    tables[i, -1] = target.tail
            else:
                # bucket-padding rows write into scratch pages
                tables[i] = srv._scratch[:nbp]
        zm = self._server_model(srv)
        lg, srv.pages = S.prefill_chunk_paged(
            zm.cfg, zm.params, self._device_array(srv, tokens), srv.pages,
            self._device_array(srv, tables),
            self._device_array(srv, starts), prompt_len=s)
        srv.stats.prefill_tokens_computed += bucket * c
        srv.stats.prefill_chunks += 1
        self.stats.prefill_chunks += 1
        self.metrics.inc("acar_prefill_chunks_total",
                         model=srv.stats.model,
                         help="chunked-prefill device programs run")
        self.stats.launches += 1
        # chunk-final logits stay on the device in the model's dtype
        for i, (srv_i, row, mx) in enumerate(rows):
            target = mx if mx is not None else row
            start0 = int(starts[i])
            target.prefill_pos = start0 + c
            sid = None
            if self.tracer is not None:
                sid = self.tracer.span(
                    "prefill_chunk", self._trace_id(row), self.now,
                    key=None if mx is None else ("m", mx.member),
                    model=srv.stats.model, start=start0, tokens=c)
            if target.prefill_pos == s:
                target.logits0 = lg[i]
                # publish to the server's prefix cache (cost-aware
                # eviction keys off tokens-saved-per-page)
                srv._prefix_insert(row.ids.tobytes(), target.shared,
                                   target.tail, lg[i], tokens=s)
                if sid is not None:
                    self.tracer.kv_insert(
                        srv.stats.model,
                        hashlib.sha256(row.ids.tobytes()).hexdigest(),
                        self._trace_id(row), sid)
        if self.tracer is not None:
            self._observe_span("prefill", t0)
        return 1

    def _run_one_shot_prefill_group(self, key, items) -> int:
        """One whole-prompt prefill launch for a non-chunkable layout
        (quant: a chunk would attend the already-quantised prefix). The
        prompt math is ``prefill``'s, only the page packing differs,
        and the virtual clock is charged the ``chunk_count(s)`` units
        the chunked path would pay. Ring and lane layouts are not
        ported yet."""
        _, _, s = key
        t0 = time.perf_counter() if self.tracer is not None else 0.0
        srv = items[0][0]
        if srv.layout != "quant":
            raise NotImplementedError(
                f"one-shot prefill of the {srv.layout!r} page layout is "
                "not ported yet")
        g = self._geometry(srv, s)
        rows = sorted(items, key=lambda it: it[1].admission)
        bucket = self.planner.decode_bucket(len(rows))
        tokens = np.zeros((bucket, s), np.int32)
        tables = np.empty((bucket, g.nbp), np.int32)
        for i in range(bucket):
            if i < len(rows):
                srv_i, row, mx = rows[i]
                target = mx if mx is not None else row
                tokens[i] = row.ids
                tables[i, :target.shared.size] = target.shared
                if target.tail is not None:
                    tables[i, -1] = target.tail
            else:
                # pad rows prefill zeros into scratch pages
                tables[i] = srv._scratch[:g.nbp]
        zm = self._server_model(srv)
        lg, srv.pages = S.prefill_paged(
            zm.cfg, zm.params, self._device_array(srv, tokens), srv.pages,
            self._device_array(srv, tables))
        srv.stats.prefill_tokens_computed += bucket * s
        self.metrics.inc("acar_prefill_oneshot_total",
                         model=srv.stats.model,
                         help="one-shot prefill device programs run "
                              "for non-chunkable page layouts")
        self.stats.launches += 1
        for i, (srv_i, row, mx) in enumerate(rows):
            target = mx if mx is not None else row
            target.prefill_pos = s
            target.logits0 = lg[i]
            srv._prefix_insert(row.ids.tobytes(), target.shared,
                               target.tail, lg[i], tokens=s)
            if self.tracer is not None:
                sid = self.tracer.span(
                    "prefill_chunk", self._trace_id(row), self.now,
                    key=None if mx is None else ("m", mx.member),
                    model=srv.stats.model, start=0, tokens=s,
                    oneshot=1)
                self.tracer.kv_insert(
                    srv.stats.model,
                    hashlib.sha256(row.ids.tobytes()).hexdigest(),
                    self._trace_id(row), sid)
        if self.tracer is not None:
            self._observe_span("prefill", t0)
        return self.planner.chunk_count(s)

    def _server_model(self, srv: PagedKVServer):
        if srv is self.probe_srv:
            return self.eng.probe
        for zm in self.eng.ensemble:
            if self.eng._stepped_server(zm) is srv:
                return zm
        raise KeyError("server has no model")

    # -- decode step ---------------------------------------------------
    def _decode_groups(self):
        """Group live lanes by (server, temperature, cache_len)."""
        groups: Dict[tuple, list] = {}
        for row in self.active:
            cache_len = row.s + self.max_new
            if row.phase == "probe_decode":
                srv = self._probe_server(row)
                for lane in row.lanes:
                    if not lane.done and lane.steps < self.max_new:
                        key = (self._group_key(srv),
                               self.acfg.probe_temperature, cache_len)
                        groups.setdefault(key, []).append(
                            (srv, row, lane))
            elif row.phase == "ensemble_decode":
                for mx in row.members:
                    lane = mx.lane
                    if (lane is not None and not lane.done
                            and lane.steps < self.max_new):
                        srv = self._probe_server(row) if mx.reuse \
                            else mx.server
                        key = (self._group_key(srv),
                               self.acfg.ensemble_temperature,
                               cache_len)
                        groups.setdefault(key, []).append(
                            (srv, row, lane))
        return groups

    def _megastep_span(self, lanes) -> int:
        """Fused ticks for one decode group. Fixed-K mode caps the
        planner's K by the group's longest remaining budget so no
        launch runs ticks *every* lane would mask. Auto mode caps by
        the *shortest* remaining budget instead. Every grouped lane is
        live (steps < max_new), so the span is always >= 1."""
        budgets = [self.max_new - l.steps for l in lanes]
        cap = min(budgets) if self.planner.megastep_auto \
            else max(budgets)
        return max(1, min(self.megastep, cap))

    def _replay_megastep(self, lane: _Lane, emits, dones, kl: int,
                         i: int) -> None:
        """Host replay of one lane's (K,) emit/done columns — exactly
        the per-tick group-membership rule: a lane already done (or
        past its budget) at offset t would not have been launched at
        tick t, so its emission is masked and counted."""
        for t in range(kl):
            if lane.done or lane.steps >= self.max_new:
                self.stats.masked_decode_steps += 1
                continue
            lane.tokens.append(int(emits[t, i]))
            lane.length += 1
            lane.steps += 1
            lane.done = bool(dones[t, i])
            self.stats.decode_tokens += 1

    def _run_decode_group(self, key, items) -> int:
        _, temperature, cache_len = key
        t0 = time.perf_counter() if self.tracer is not None else 0.0
        srv = items[0][0]
        nb = srv.table_width(cache_len - self.max_new, self.max_new)
        ordered = sorted(items, key=lambda it: (it[1].admission,
                                                it[2].tag))
        lanes = [it[2] for it in ordered]
        penalty = 0
        if self.injector is not None:
            penalty = self._member_fault_gate(ordered)
            if penalty < 0:
                return 0               # group quarantined pre-launch
        tok0 = [len(l.tokens) for l in lanes] \
            if self.journal is not None else None
        bucket = self.planner.decode_bucket(len(lanes))
        k = len(lanes)
        kl = self._megastep_span(lanes)
        tables = np.empty((bucket, nb), np.int32)
        pos = np.empty(bucket, np.int32)
        keys = np.empty((bucket, 2), np.int64)
        steps = np.empty(bucket, np.int32)
        done = np.zeros(bucket, bool)
        for i in range(bucket):
            lane = lanes[min(i, k - 1)]
            tables[i] = lane.block_table if i < k else srv._scratch[:nb]
            pos[i] = cache_len - self.max_new + lane.steps
            keys[i] = lane.row_key
            steps[i] = lane.steps
            # pad rows emit pads into scratch; a lane a quarantine
            # dropped earlier this tick decodes masked (its pages are
            # already released)
            done[i] = i >= k or lane.done
        # lane logits never left the device: stacking them is a
        # device-side gather
        logits = torch.stack([lanes[min(i, k - 1)].logits
                              for i in range(bucket)])
        zm = self._server_model(srv)
        (emits, dones, next_logits,
         srv.pages) = S.decode_megastep_rows(
            zm.cfg, zm.params, logits, srv.pages,
            self._device_array(srv, tables), self._device_array(srv, pos),
            self._device_array(srv, keys), self._device_array(srv, steps),
            self._device_array(srv, done), n_ticks=kl,
            cache_len=cache_len, temperature=temperature,
            eos_id=tok.EOS, pad_id=tok.PAD)
        # the megastep's only host pulls: (K, B) token ids + done bits
        emits = emits.cpu().numpy()
        dones = dones.cpu().numpy()
        self.stats.launches += 1
        self.stats.decode_h2d += 5     # tables, pos, keys, steps, done
        self.stats.decode_d2h += 2     # emits, dones
        if (self.injector is not None
                and all(l.tag >= 100 for l in lanes)
                and not torch.isfinite(
                    next_logits[:k].float()).all().item()):
            # genuine non-finite member logits: discard the launch
            # (lane state is untouched) and quarantine — only checked
            # while an injector is attached, so the fault-free path
            # never pays the extra device sync
            self._quarantine_group(ordered, srv.stats.model,
                                   "nan_logits")
            return kl + penalty
        for i, lane in enumerate(lanes):
            self._replay_megastep(lane, emits, dones, kl, i)
            lane.logits = next_logits[i]
        if self.tracer is not None:
            # one span per (row, lane) per megastep launch; lane
            # streams chain launch-to-launch, parented on the row
            # lifecycle (probe lanes) or the member launch (members)
            for it, lane in zip(ordered, lanes):
                probe = lane.tag < 100
                self.tracer.span(
                    "probe_decode" if probe else "member_decode",
                    self._trace_id(it[1]), self.now,
                    key=("p", lane.tag) if probe
                    else ("m", lane.tag - 100),
                    member=None if probe else lane.tag - 100,
                    model=srv.stats.model, ticks=kl,
                    steps=lane.steps, done=int(lane.done))
            d = time.perf_counter() - t0
            self.metrics.observe(
                "acar_span_duration", d,
                phase="probe_decode" if lanes[0].tag < 100
                else "ensemble_decode",
                help="host wall seconds per traced lifecycle phase")
            self.metrics.observe(
                "acar_decode_launch_seconds", d,
                server=srv.stats.model,
                help="wall seconds per megastep decode launch")
        if self.journal is not None:
            self.journal.emit(self.now, srv.stats.model, [
                [it[1].admission, lane.tag, lane.steps,
                 int(lane.done), lane.tokens[tok0[i]:]]
                for i, (it, lane) in enumerate(zip(ordered, lanes))])
        self.metrics.set_gauge(
            "acar_step_bucket_occupancy", k / bucket,
            server=srv.stats.model, bucket=str(bucket),
            help="live-lane fill of the last step-decode bucket")
        return kl + penalty

    # -- phase transitions ---------------------------------------------
    def _promote(self) -> None:
        """Host-side transitions after this tick's device work."""
        # prefill finished -> probe decode
        for row in self.active:
            if row.phase == "prefill" and row.prefill_pos == row.s:
                self._begin_probe_decode(row)
        # probe decode finished -> route
        resolved = [row for row in self.active
                    if row.phase == "probe_decode"
                    and all(l.done or l.steps >= self.max_new
                            for l in row.lanes)]
        if resolved:
            self._route(sorted(resolved, key=lambda r: r.admission))
        # member prefill finished or cache hit -> member decode lanes
        for row in self.active:
            if row.phase != "ensemble_decode":
                continue
            for mx in row.members:
                if (mx.lane is None and mx.answer is None
                        and not mx.reuse and mx.logits0 is not None):
                    self._begin_member_decode(row, mx)
            self._finish_members(row)

    def _route(self, rows: List[_Row]) -> None:
        from repro_torch.serving.engine import intern_answers
        t0 = time.perf_counter() if self.tracer is not None else 0.0
        n = self.n
        self._routed_this_tick += len(rows)
        # batched route-time extract: decode + extract every row
        # routing this tick in one call (duplicate probe texts are
        # extracted once)
        texts_all: List[str] = []
        kinds_all: List[str] = []
        for row in rows:
            texts = [tok.decode(l.harvest(self.max_new, tok.PAD))
                     for l in row.lanes]
            row.probe_texts = texts
            texts_all.extend(texts)
            kinds_all.extend([row.request.task.kind] * len(texts))
        answers_all = extract_batch(texts_all, kinds_all)
        off = 0
        for row in rows:
            row.probe_answers = answers_all[off:off + len(row.lanes)]
            off += len(row.lanes)
            srv = self._probe_server(row)
            srv.pool.release(row.sample_tails.reshape(-1))
            row.sample_tails = None
            row.lanes = []
            srv._sample_usage()
        # per-row interning namespaces: sigma/majority/judge are
        # within-row functions, invariant to interning order
        ids = np.stack([intern_answers(row.probe_answers)
                        for row in rows]).reshape(len(rows), n)
        sig = sigma_batch(torch.from_numpy(ids))
        modes = np.asarray(self.eng.route_modes(
            sig, [r.admission for r in rows]))
        sig_np = sig.numpy()
        for i, row in enumerate(rows):
            row.sigma = float(sig_np[i])
            row.mode = int(modes[i])
            if self._quarantined:
                self._apply_degraded_mode(row)
            if self.tracer is not None:
                self.tracer.span("route", self._trace_id(row),
                                 self.now, sigma=row.sigma,
                                 mode=row.mode,
                                 n_samples=len(row.probe_answers))
            row.member_answers = [None] * len(self.eng.ensemble)
            self._spawn_members(row)
        if self.tracer is not None:
            self._observe_span("route", t0)

    def _member_needed(self, mode: int, mi: int) -> bool:
        if mi in self._quarantined:
            return False
        return mode >= (1 if mi < self.acfg.arena_lite_size else 2)

    def _spawn_members(self, row: _Row) -> None:
        eng = self.eng
        needed = [mi for mi in range(len(eng.ensemble))
                  if self._member_needed(row.mode, mi)]
        if not needed:
            self._release_prompt(self._probe_server(row), row)
            self._judge(row)       # mode 0: final = probe majority
            self._retire(row)
            return

        row.phase = "ensemble_decode"
        for mi in needed:
            zm = eng.ensemble[mi]
            srv_m = self._member_server(zm, row)
            reuse = self._reuse_member(zm, row)
            mx = _MemberExec(member=mi, server=srv_m, reuse=reuse)
            row.members.append(mx)
            if self.tracer is not None:
                self.tracer.span("member_launch", self._trace_id(row),
                                 self.now, key=("m", mi), member=mi,
                                 model=zm.name, reuse=int(reuse))
            if reuse:
                self._begin_member_decode(row, mx)
            elif srv_m is not None:
                entry = srv_m._prefix_lookup(row.ids.tobytes())
                if entry is not None:
                    srv_m.pool.retain(entry.shared)
                    if entry.tail is not None:
                        srv_m.pool.retain([entry.tail])
                    mx.shared = entry.shared.copy()
                    mx.tail = entry.tail
                    mx.logits0 = entry.logits0.clone()
                    mx.from_cache = True
                    mx.prefill_pos = row.s
                    srv_m.stats.prefill_tokens_reused_prefix += row.s
                    if self.tracer is not None:
                        self._kv_reuse_span(srv_m.stats.model, row,
                                            "prefix", key=("m", mi))
                    self._begin_member_decode(row, mx)
                else:
                    g = self._geometry(srv_m, row.s)
                    pages = srv_m._alloc_retry(g.nbp)
                    mx.shared = pages[:g.n_shared]
                    mx.tail = int(pages[g.n_shared]) \
                        if g.tail_tokens else None
            else:
                self._dense_member(row, mx, zm)
        if not any(mx.reuse for mx in row.members):
            # no member seeds from the probe's pages: free them the
            # moment the route resolves
            self._release_prompt(self._probe_server(row), row)
        self._finish_members(row)

    def _begin_member_decode(self, row: _Row, mx: _MemberExec) -> None:
        srv = self._probe_server(row) if mx.reuse else mx.server
        s = row.s
        g = self._geometry(srv, s)
        tails = srv._alloc_retry(g.n_tail)
        if mx.reuse:
            self._unreserve(row, g.n_tail)
        mx.tails = tails
        table = np.empty(g.nb, np.int32)
        shared = row.shared if mx.reuse else mx.shared
        canon_tail = row.tail if mx.reuse else mx.tail
        if g.n_shared:
            table[:g.n_shared] = shared
        table[g.n_shared:] = tails
        if g.tail_tokens:
            self._fork(srv, [canon_tail], [int(tails[0])])
            srv.stats.cow_forks += 1
        key = S.member_row_keys(self.base_key, [row.admission],
                                mx.member)[0]
        logits0 = row.logits0 if mx.reuse else mx.logits0
        mx.lane = _Lane(block_table=table, row_key=key,
                        logits=logits0.clone(), tag=100 + mx.member)
        if mx.reuse:
            srv.stats.prefill_tokens_reused_probe += s
            if self.tracer is not None:
                self._kv_reuse_span(srv.stats.model, row, "probe",
                                    key=("m", mx.member))

    def _dense_member(self, row: _Row, mx: _MemberExec, zm) -> None:
        raise NotImplementedError(
            f"member {zm.name!r} has no paged layout; the dense-cache "
            "member fallback is not ported yet")

    def _finish_members(self, row: _Row) -> None:
        srv = self._probe_server(row)
        for mx in row.members:
            lane = mx.lane
            if (mx.answer is None and lane is not None
                    and (lane.done or lane.steps >= self.max_new)):
                text = tok.decode(lane.harvest(self.max_new, tok.PAD))
                mx.answer = extract(text, row.request.task.kind)
                dsrv = srv if mx.reuse else mx.server
                dsrv.pool.release(mx.tails)
                mx.tails = None
                mx.lane = None
                if not mx.reuse and mx.shared is not None:
                    self._release_prompt(dsrv, mx)
        if all(mx.answer is not None for mx in row.members):
            for mx in row.members:
                row.member_answers[mx.member] = mx.answer
            self._release_prompt(srv, row)
            self._judge(row)
            self._retire(row)

    def _judge(self, row: _Row) -> None:
        from repro_torch.serving.engine import intern_answers, judge_batch
        t0 = time.perf_counter() if self.tracer is not None else 0.0
        table: Dict[str, int] = {}
        probe_ids = intern_answers(row.probe_answers,
                                   table).reshape(1, self.n)
        col = np.full(len(self.eng.ensemble), -1, np.int32)
        for mi, a in enumerate(row.member_answers):
            if a is not None:
                col[mi] = table.setdefault(a, len(table))
        final = judge_batch(
            torch.from_numpy(col[None]),
            majority_vote_batch(torch.from_numpy(probe_ids)),
            torch.tensor([row.mode], dtype=torch.int32))
        rev = {v: k for k, v in table.items()}
        row.final_answer = rev[int(final[0])]
        if self.tracer is not None:
            self.tracer.span(
                "judge", self._trace_id(row), self.now, mode=row.mode,
                members=[mi for mi, a
                         in enumerate(row.member_answers or [])
                         if a is not None])
            self._observe_span("judge", t0)

    def _retire(self, row: _Row) -> None:
        self._unreserve(row, row.reserved)
        row.phase = "done"
        row.retired_at = self.now
        arr, adm, _ = self.stats.timeline[row.admission]
        self.stats.timeline[row.admission] = (arr, adm, self.now)
        self.stats.retired += 1
        self.done_rows[row.admission] = row
        if self.journal is not None:
            self.journal.retire({
                "adm": row.admission,
                "task_id": row.request.task.task_id,
                "sigma": row.sigma, "mode": row.mode,
                "probe_texts": row.probe_texts,
                "probe_answers": row.probe_answers,
                "member_answers": row.member_answers,
                "final_answer": row.final_answer,
                "aborted": row.aborted,
                "timeline": list(self.stats.timeline[row.admission]),
            }, self.now)
        if self.tracer is not None:
            self.tracer.span("retire", self._trace_id(row), self.now,
                             task_id=row.request.task.task_id,
                             final_answer=row.final_answer,
                             sigma=row.sigma, mode=row.mode,
                             aborted=row.aborted)
            if (getattr(self.tracer, "attribution", False)
                    and row.mode >= 2 and row.aborted is None
                    and row.member_answers is not None):
                # full-arena row: schedule on-capacity leave-one-out
                # recomputation (drained on idle ticks; see run())
                self._attrib_queue.append(row)

    # -- on-capacity counterfactual attribution ------------------------
    def _attribute_row(self, row: _Row) -> None:
        """Recompute ground-truth leave-one-out judge counterfactuals
        for one escalated row and emit them as a hashed span. Uses the
        same ``core.attribution`` oracle the offline analysis calls, so
        the on-capacity values are numerically identical by
        construction."""
        from repro_torch.core.attribution import leave_one_out
        from repro_torch.teamllm.trace import ModelResponse
        task = row.request.task
        responses = [
            ModelResponse(model=self.eng.ensemble[mi].name,
                          response="", answer=a, cost=0.0)
            for mi, a in enumerate(row.member_answers)
            if a is not None]
        loo = leave_one_out(responses, task.task_id, task.gold)
        self.tracer.span(
            "attribution", self._trace_id(row), self.now,
            task_id=task.task_id, mode=row.mode,
            values={m: float(v) for m, v in loo.items()})

    def _drain_attribution(self, quota: int) -> None:
        while self._attrib_queue and quota > 0:
            self._attribute_row(self._attrib_queue.pop(0))
            quota -= 1
            self.metrics.inc(
                "acar_attribution_rows_total",
                help="escalated rows with on-capacity leave-one-out "
                     "attribution recomputed")

    def kv_stats(self):
        """Measured paged-KV accounting per model for this run."""
        return self.eng.kv_stats()

    # -- main loop -----------------------------------------------------
    def _emit_phase_gauges(self) -> None:
        counts = {p: 0 for p in PHASES}
        for row in self.active:
            counts[row.phase] += 1
        counts["done"] = self.stats.retired
        # route-pending is transient within a tick (routing resolves
        # on the host the same step probe decode finishes): report
        # the rows that passed through it this step
        counts["route_pending"] = self._routed_this_tick
        for phase, v in counts.items():
            self.metrics.set_gauge(
                "acar_step_rows_active", v, phase=phase,
                help="rows per lifecycle phase at the last step "
                     "(route_pending: resolved within this step)")

    def run(self) -> StepStats:
        while len(self.queue) or self.active:
            self._admit_ready()
            if self.injector is not None:
                self._fault_tick()
            per_server: Dict[object, int] = {}
            self._routed_this_tick = 0
            for key, items in sorted(self._prefill_groups().items(),
                                     key=lambda kv: kv[0][1:]):
                cost = self._run_prefill_group(key, items)
                per_server[key[0]] = per_server.get(key[0], 0) + cost
            for key, items in sorted(self._decode_groups().items(),
                                     key=lambda kv: (kv[0][1],
                                                     kv[0][2])):
                # a megastep launch charges its fused tick count: the
                # virtual clock measures device occupancy, not launch
                # overhead
                kl = self._run_decode_group(key, items)
                per_server[key[0]] = per_server.get(key[0], 0) + kl
            self._promote()
            self.active = [r for r in self.active if r.phase != "done"]
            self._emit_phase_gauges()
            # servers are independent executors: the tick takes as
            # long as its busiest server; same-server programs
            # serialize. Idle ticks launch nothing but time passes.
            tick_cost = max(per_server.values(), default=0)
            if self.tracer is not None and self._attrib_queue:
                # attribution is pure host recompute over retired
                # rows: spend idle device ticks on it, never busy ones
                self._drain_attribution(self.planner.attribution_quota(
                    tick_cost, len(self._attrib_queue)))
            self.stats.ticks += 1
            self.stats.invocations += sum(per_server.values())
            self.now += max(1, tick_cost)
            if tick_cost == 0 and not self.active and len(self.queue):
                # idle: jump the virtual clock to the next admission
                # event (a future arrival, or the oldest request's
                # fill-or-timeout instant)
                head = self.queue.peek()
                if head.arrival_time > self.now:
                    self.now = head.arrival_time
                elif not self.queue.ready(self.now):
                    nxt = self.queue.next_ready_at()
                    if nxt is not None:
                        self.now = max(self.now, nxt)
        if self.tracer is not None and self._attrib_queue:
            # the run drained before the queue did: flush the rest so
            # every escalated row gets its counterfactual events
            self._drain_attribution(len(self._attrib_queue))
        if self.stats.masked_decode_steps:
            self.metrics.inc(
                "acar_step_masked_decode_steps_total",
                self.stats.masked_decode_steps,
                help="decode ticks lanes sat masked because they "
                     "finished mid-megastep")
        return self.stats


class ShardedStepLoopRunner(StepLoopRunner):
    """The mesh-sharded step loop (per-shard page pools over several
    cards) is not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "the sharded step loop is not ported yet")
