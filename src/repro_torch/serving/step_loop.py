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

Fault injection, the write-ahead journal, crash recovery, span tracing,
on-capacity attribution, the ring and lane layouts, dense-cache member
fallback and the sharded runner are not ported yet; reaching them
raises ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.extract import extract, extract_batch
from repro_torch.core.sigma import majority_vote_batch, sigma_batch
from repro_torch.data import tokenizer as tok
from repro_torch.sampling import prng
from repro_torch.sampling import sampler as S
from repro_torch.serving.kv_pool import (
    PagedKVServer, PagePoolError, PoolExhausted, pages_for)
from repro_torch.serving.metrics import PromCounters
from repro_torch.serving.queue import AdmissionQueue, Request
from repro_torch.serving.scheduler import StepPlanner

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
    requeues: int = 0                  # admissions requeued (alloc)
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
                 metrics: Optional[PromCounters] = None):
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
            self._begin_prefill(row)
            return True
        except PoolExhausted:
            self._rollback_admission(row)
            self.queue.requeue(row.request)
            self.stats.requeues += 1
            self.metrics.inc(
                "acar_step_requeues_total",
                help="admissions requeued on PoolExhausted")
            return False

    # -- admission -----------------------------------------------------
    def _admit_ready(self) -> None:
        while len(self.queue):
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
            if not self._try_begin_prefill(row):
                break
            self.active.append(row)
            self.stats.admissions += 1
            self.metrics.inc("acar_step_admissions_total",
                             help="rows admitted into the step loop")

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
            if target.prefill_pos == s:
                target.logits0 = lg[i]
                # publish to the server's prefix cache (cost-aware
                # eviction keys off tokens-saved-per-page)
                srv._prefix_insert(row.ids.tobytes(), target.shared,
                                   target.tail, lg[i], tokens=s)
        return 1

    def _run_one_shot_prefill_group(self, key, items) -> int:
        """One whole-prompt prefill launch for a non-chunkable layout
        (quant: a chunk would attend the already-quantised prefix). The
        prompt math is ``prefill``'s, only the page packing differs,
        and the virtual clock is charged the ``chunk_count(s)`` units
        the chunked path would pay. Ring and lane layouts are not
        ported yet."""
        _, _, s = key
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
        srv = items[0][0]
        nb = srv.table_width(cache_len - self.max_new, self.max_new)
        ordered = sorted(items, key=lambda it: (it[1].admission,
                                                it[2].tag))
        lanes = [it[2] for it in ordered]
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
            # pad rows emit pads into scratch
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
        for i, lane in enumerate(lanes):
            self._replay_megastep(lane, emits, dones, kl, i)
            lane.logits = next_logits[i]
        self.metrics.set_gauge(
            "acar_step_bucket_occupancy", k / bucket,
            server=srv.stats.model, bucket=str(bucket),
            help="live-lane fill of the last step-decode bucket")
        return kl

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
            row.member_answers = [None] * len(self.eng.ensemble)
            self._spawn_members(row)

    def _member_needed(self, mode: int, mi: int) -> bool:
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

    def _retire(self, row: _Row) -> None:
        self._unreserve(row, row.reserved)
        row.phase = "done"
        row.retired_at = self.now
        arr, adm, _ = self.stats.timeline[row.admission]
        self.stats.timeline[row.admission] = (arr, adm, self.now)
        self.stats.retired += 1
        self.done_rows[row.admission] = row

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
