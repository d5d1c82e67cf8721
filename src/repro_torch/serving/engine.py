"""Batched ACAR serving engine — Algorithm 1 of the paper over real
models.

The port of ``repro/serving/engine.py``. Three entry points serve a
stream: ``run_batch`` runs one lockstep wave (the default path of
``launch.serve``), ``run_queued`` forms micro-batches through the
admission queue and runs each as a wave, and ``run_stepped`` runs the
step-level loop. In each, the probe's N samples decode over one shared
prefill, sigma over the interned probe answers routes each task
(single / arena-lite / full-arena), only the escalated tasks decode on
the ensemble members (the probe's twin reuses the probe's prompt
pages), and the judge aggregates. Answers are canonicalised on the
host (``core.extract``) and interned to int32 ids; sigma, routing and
the judge run as tensor math over the ids on the host.

In the wave, two compute-follows-routing optimisations make decode
cost follow what the router escalated: the shared-prefix probe prefill
(one prefill per prompt, its pages or cache shared by the N samples)
and escalated-subset compaction (members decode only the rows they are
needed for, gathered into power-of-two buckets — ``compaction.py``).
Both engage only where they cannot change a row's tokens, and
``compact=False`` / ``shared_prefix=False`` turn them off (the masked
baseline: members decode the whole wave, the probe prefills each
prompt N times over the tiled (B·N) expansion). With ``paged=False``
the wave decodes over contiguous caches instead of pool pages, as the
reference's A/B baseline and pool-exhaustion fallback do.

The stepped engine takes a fault plan, a write-ahead journal and a span
tracer, and ``recover`` resumes a killed journaled run to the same
outputs and record hashes; ``run_batch`` takes a tracer too and emits
the wave's spans after it resolves, as does ``run_queued``.
``run_stepped(data_shards=, model_shards=)`` serves through the sharded
loop over a ``ServingMesh`` (``serving/mesh.py``). The engine keeps no artifact
store of its own (a caller chains its results through ``teamllm``, as
the orchestrator does).
"""
from __future__ import annotations

import inspect
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.acar import ACARConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.core.extract import extract
from repro_torch.core.sigma import (
    MODE_NAMES, majority_vote_batch, route_batch, sigma_batch)
from repro_torch.data import tokenizer as tok
from repro_torch.data.tasks import Task
from repro_torch.models.transformer import resolve_layout
from repro_torch.runtime import deterministic_cuda
from repro_torch.sampling import (
    batch_invariant, generate, generate_samples, member_row_keys,
    probe_row_keys)
from repro_torch.sampling import prng
from repro_torch.serving.compaction import CompactionStats, plan_compaction
from repro_torch.serving.kv_pool import (
    KVStats, PagedKVServer, PoolExhausted, ProbeHandle)
from repro_torch.serving.metrics import PromCounters
from repro_torch.serving.queue import AdmissionQueue, MicroBatchPolicy


@dataclass
class ZooModel:
    name: str
    cfg: ModelConfig
    params: dict


def intern_answers(answers: Sequence[str],
                   table: Optional[Dict[str, int]] = None) -> np.ndarray:
    """Intern canonical answer strings to dense int32 ids.

    Pass ``table`` to thread one namespace through several calls (the
    engine interns probe and ensemble answers into a single table)."""
    if table is None:
        table = {}
    out = np.empty(len(answers), np.int32)
    for i, a in enumerate(answers):
        out[i] = table.setdefault(a, len(table))
    return out


def judge_batch(member_ids: torch.Tensor, probe_majority: torch.Tensor,
                modes: torch.Tensor) -> torch.Tensor:
    """Vectorised aggregation. member_ids: (B, M) answer ids (M ensemble
    members, invalid entries = -1); probe_majority: (B,); modes: (B,).

    single_agent -> probe majority.
    arena_lite   -> probe majority unless the first two members agree on
                    a common different answer.
    full_arena   -> plurality over members, probe majority breaks ties.
    """
    # plurality over valid member answers
    valid = member_ids >= 0
    eq = ((member_ids[:, :, None] == member_ids[:, None, :])
          & valid[:, :, None] & valid[:, None, :])
    votes = eq.sum(-1)                                   # (B, M)
    # prefer answers matching probe majority on vote ties
    bonus = (member_ids == probe_majority[:, None]) & valid
    score = votes * 2 + bonus.to(votes.dtype)
    best = torch.argmax(torch.where(valid, score, torch.full_like(score, -1)),
                        dim=-1)
    plural = torch.gather(member_ids, 1, best[:, None])[:, 0]

    # a one-member ensemble: the reference's out-of-range column 1
    # clamps to column 0 (XLA's gather), so "the first two agree" is
    # the one member's answer being valid
    j = min(1, member_ids.shape[1] - 1)
    two_agree = ((member_ids[:, 0] == member_ids[:, j])
                 & valid[:, 0] & valid[:, j])
    lite = torch.where(two_agree & (member_ids[:, 0] != probe_majority),
                       member_ids[:, 0], probe_majority)

    return torch.where(modes == 0, probe_majority,
                       torch.where(modes == 1, lite, plural))


@dataclass
class BatchResult:
    sigma: np.ndarray            # (B,)
    modes: np.ndarray            # (B,) int mode ids
    final_answers: List[str]
    probe_texts: List[List[str]]
    ensemble_calls_saved: int
    wall_ms: float
    # per-row, per-member extracted answers; None where the router did
    # not escalate the row to that member (exactly the judge's -1
    # entries) — identical between compacted and masked execution
    member_answers: Optional[List[List[Optional[str]]]] = None
    compaction: Optional[CompactionStats] = None


class BatchedACAREngine:
    """Batched ACAR engine over real zoo models.

    ``shared_prefix`` prefills each probe prompt once and shares it
    across the N samples (pool pages, or a tiled cache); ``compact``
    lets greedy members decode only their escalated rows. Both hold
    only for batch-invariant configs (``sampling.batch_invariant``:
    every config the port serves), and turning them off is only needed
    for A/B measurement: the masked baseline prefills each prompt N
    times and decodes members over the whole wave. ``paged`` None
    serves every model whose config has a dense or quant page layout
    from pool pages; False serves the wave over contiguous caches.
    ``route_fn`` overrides sigma->mode routing (benchmarks use it to
    force escalation rates). Page pools and caches live on ``device``;
    the models' params must already be there."""

    def __init__(self, acfg: ACARConfig, probe: ZooModel,
                 ensemble: Sequence[ZooModel],
                 max_new_tokens: int = 8, compact: bool = True,
                 shared_prefix: bool = True,
                 paged: Optional[bool] = None,
                 kv_page_size: int = 8,
                 kv_prefix_cache: int = 32,
                 route_fn: Optional[Callable] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.acfg = acfg
        self.probe = probe
        self.ensemble = list(ensemble)
        self.max_new_tokens = max_new_tokens
        self.compact = compact
        self.shared_prefix = shared_prefix
        self.paged = paged
        self.kv_page_size = kv_page_size
        self.kv_prefix_cache = kv_prefix_cache
        self.device = torch.device(device)
        if self.device.type == "cuda":
            deterministic_cuda()
        self._kv_servers: Dict[int, PagedKVServer] = {}
        self._stepped_servers: Dict[int, PagedKVServer] = {}
        # the sharded step loop's servers of the last sharded run
        self._mesh_servers: List[object] = []
        self._kv_emitted: Dict[tuple, int] = {}
        self.route_fn = route_fn or route_batch
        # a route_fn may take (sigma, admission_indices) so forced-mode
        # benchmarks stay deterministic under out-of-order (step-level)
        # route resolution; plain sigma-only callables keep working
        try:
            n_params = len([
                p for p in inspect.signature(
                    self.route_fn).parameters.values()
                if p.kind in (p.POSITIONAL_ONLY,
                              p.POSITIONAL_OR_KEYWORD)])
        except (TypeError, ValueError):
            n_params = 1
        self._route_takes_indices = n_params >= 2

    # -- paged KV servers ----------------------------------------------
    def _kv_server(self, zm: ZooModel) -> Optional[PagedKVServer]:
        """One server per distinct params object: an ensemble member
        that *is* the probe model shares the probe's server, which is
        what makes probe->ensemble prefill-page reuse sound (KV is a
        function of params, not just configs). Wave serving speaks the
        dense and quant page layouts; ring and lanes members serve over
        contiguous caches in the wave and take their layouts through
        ``_stepped_server`` in the step loop. ``paged=False`` serves
        none."""
        if (self.paged is False
                or resolve_layout(zm.cfg) not in ("dense", "quant")):
            return None
        key = id(zm.params)
        srv = self._kv_servers.get(key)
        if srv is None:
            srv = PagedKVServer(zm.cfg, page_size=self.kv_page_size,
                                prefix_cache_entries=self.kv_prefix_cache,
                                device=self.device)
            srv.stats.model = zm.name
            self._kv_servers[key] = srv
        return srv

    def _stepped_server(self, zm: ZooModel) -> Optional[PagedKVServer]:
        """Server for the step-level loop, which also speaks the ring
        (sliding-window) and lanes (recurrent-state) layouts. Dense and
        quant members get the *same object* as ``_kv_server``:
        ``_kv_reuse_member`` compares servers by identity. A member no
        layout serves (the hybrid stack) gets None and decodes over a
        contiguous cache."""
        if self.paged is False:
            return None
        layout = resolve_layout(zm.cfg)
        if layout is None:
            return None
        if layout in ("dense", "quant"):
            return self._kv_server(zm)
        key = id(zm.params)
        srv = self._stepped_servers.get(key)
        if srv is None:
            srv = PagedKVServer(zm.cfg, page_size=self.kv_page_size,
                                prefix_cache_entries=self.kv_prefix_cache,
                                device=self.device)
            srv.stats.model = zm.name
            self._stepped_servers[key] = srv
        return srv

    def kv_stats(self) -> Dict[str, KVStats]:
        """Measured paged-KV accounting per model server (wave and
        stepped servers merged; dense and quant members are one server
        in both roles)."""
        out = {srv.stats.model: srv.stats
               for srv in self._kv_servers.values()}
        for srv in self._stepped_servers.values():
            out.setdefault(srv.stats.model, srv.stats)
        return out

    def _kv_reuse_member(self, zm: ZooModel,
                         kv_srv: Optional[PagedKVServer]) -> bool:
        return (kv_srv is not None and zm.cfg == self.probe.cfg
                and self._kv_server(zm) is kv_srv)

    def _member_compactable(self, zm: ZooModel) -> bool:
        """Compaction (and seeding a member's decode from the probe's
        pages) must not perturb the decoded rows: greedy decode
        (temperature-0 sampling is batch-shape independent, categorical
        draws are not) of a batch-invariant config."""
        return (self.compact
                and self.acfg.ensemble_temperature <= 0.0
                and batch_invariant(zm.cfg))

    def route_modes(self, sig, admission_indices):
        """Invoke route_fn, passing admission indices when it wants
        them (forced-rate benchmarks key modes off task identity)."""
        if self._route_takes_indices:
            return self.route_fn(sig, list(admission_indices))
        return self.route_fn(sig)

    # ------------------------------------------------------------------
    # wave entry point
    # ------------------------------------------------------------------
    def _decode_texts(self, out_tokens) -> List[str]:
        return [tok.decode(row) for row in np.asarray(out_tokens)]

    def _probe_decode(self, ids: np.ndarray, key: np.ndarray,
                      stats: CompactionStats,
                      row_keys=None) -> List[str]:
        """N-sample probe decode over contiguous caches: one prefill per
        prompt, its cache tiled to the N samples (``shared_prefix``);
        otherwise the tiled (B·N) expansion, each prompt prefilled N
        times."""
        b, s = ids.shape
        n = self.acfg.n_probe_samples
        stats.probe_prefill_tokens += b * s
        if self.shared_prefix and batch_invariant(self.probe.cfg):
            out = generate_samples(
                self.probe.cfg, self.probe.params, ids, n,
                max_new_tokens=self.max_new_tokens,
                temperature=self.acfg.probe_temperature,
                key=key, eos_id=tok.EOS, pad_id=tok.PAD,
                row_keys=row_keys)
            saved = b * (n - 1) * s
            stats.probe_prefill_tokens_saved += saved
            stats.probe_prefill_flops_saved += \
                2.0 * self.probe.cfg.active_param_count() * saved
        else:
            stats.probe_prefill_tokens += b * (n - 1) * s
            out = generate(
                self.probe.cfg, self.probe.params, np.repeat(ids, n, axis=0),
                max_new_tokens=self.max_new_tokens,
                temperature=self.acfg.probe_temperature,
                key=key, eos_id=tok.EOS, pad_id=tok.PAD, row_keys=row_keys)
        return self._decode_texts(out.tokens.cpu())

    def _member_decode(self, zm: ZooModel,
                       srv_m: Optional[PagedKVServer],
                       sub_ids: np.ndarray, mkey: np.ndarray,
                       row_keys=None):
        """One ensemble member decode over ``sub_ids`` rows: paged when
        the member has a server, over a contiguous cache otherwise. A
        paged decode that exhausts its pool even after prefix eviction
        falls back to the contiguous cache instead of failing the
        wave."""
        if srv_m is not None:
            try:
                return srv_m.generate(
                    zm.params, sub_ids,
                    max_new_tokens=self.max_new_tokens,
                    temperature=self.acfg.ensemble_temperature,
                    key=mkey, eos_id=tok.EOS, pad_id=tok.PAD,
                    row_keys=row_keys)
            except PoolExhausted:
                pass
        return generate(zm.cfg, zm.params, sub_ids,
                        max_new_tokens=self.max_new_tokens,
                        temperature=self.acfg.ensemble_temperature,
                        key=mkey, eos_id=tok.EOS, pad_id=tok.PAD,
                        row_keys=row_keys)

    def _probe_decode_paged(self, ids: np.ndarray, key: np.ndarray,
                            stats: CompactionStats,
                            kv_srv: PagedKVServer, row_keys=None
                            ) -> Tuple[List[str], ProbeHandle]:
        """Paged N-sample probe: one prefill per uncached prompt, the
        samples share read-only prefix pages (COW fork of the tail),
        and the prompt pages stay retained for ensemble seeding.
        Prefill accounting records what actually ran (prefix-cache hits
        and bucket padding included)."""
        b, s = ids.shape
        n = self.acfg.n_probe_samples
        computed0 = kv_srv.stats.prefill_tokens_computed
        out, handle = kv_srv.probe_wave(
            self.probe.params, ids, n,
            max_new_tokens=self.max_new_tokens,
            temperature=self.acfg.probe_temperature, key=key,
            eos_id=tok.EOS, pad_id=tok.PAD, row_keys=row_keys)
        computed = kv_srv.stats.prefill_tokens_computed - computed0
        saved = b * n * s - computed
        stats.probe_prefill_tokens += computed
        stats.probe_prefill_tokens_saved += saved
        stats.probe_prefill_flops_saved += \
            2.0 * self.probe.cfg.active_param_count() * saved
        return self._decode_texts(out.tokens), handle

    def run_batch(self, tasks: Sequence[Task], start_index: int = 0,
                  tracer=None,
                  request_ids: Optional[Sequence[str]] = None
                  ) -> BatchResult:
        """One wave over ``tasks``. ``start_index`` is the admission
        index of the first row — the stable per-task identity that
        seeds every row's sampling key stream, so a task emits the
        same tokens whether it is served in this wave, another wave,
        or the step-level loop.

        ``tracer`` (serving/tracing.py) emits the wave path's
        lifecycle spans post-hoc after the wave resolves — the wave is
        lockstep, so per-phase spans at ``tick = admission index``
        carry the same decision fields the step loop records live.
        ``request_ids`` names the traces (one per task); absent, a
        task-derived id is used."""
        t0 = time.perf_counter()
        tracer = tracer if (tracer is not None
                            and getattr(tracer, "armed", False)) \
            else None
        b = len(tasks)
        n = self.acfg.n_probe_samples
        ids = tok.encode_aligned([t.text for t in tasks])
        key = prng.prng_key(self.acfg.seed)
        admission = list(range(start_index, start_index + b))
        probe_keys = probe_row_keys(key, admission, n)
        stats = CompactionStats(batch=b)
        kv_srv = self._kv_server(self.probe) if self.shared_prefix \
            else None
        handle: Optional[ProbeHandle] = None
        if kv_srv is not None:
            try:
                texts, handle = self._probe_decode_paged(
                    ids, key, stats, kv_srv, row_keys=probe_keys)
            except PoolExhausted:
                # eviction could not free enough pages: serve the wave
                # over contiguous caches (same tokens) rather than fail
                kv_srv = None
                texts = self._probe_decode(ids, key, stats,
                                           row_keys=probe_keys)
        else:
            texts = self._probe_decode(ids, key, stats,
                                       row_keys=probe_keys)
        try:
            answers = [extract(texts[i * n + j], tasks[i].kind)
                       for i in range(b) for j in range(n)]
            # one interning table for the whole batch: probe ids first,
            # ensemble answers join the same namespace below
            id_table: Dict[str, int] = {}
            answer_ids = intern_answers(answers, id_table).reshape(b, n)

            sig = sigma_batch(torch.from_numpy(answer_ids))
            modes = self.route_modes(sig, admission)
            probe_major = majority_vote_batch(torch.from_numpy(answer_ids))

            # ensemble decodes over the escalated subset: gather rows
            # into power-of-two buckets, decode, scatter answers back;
            # masked full-batch decode when compaction cannot engage
            modes_np = np.asarray(modes)
            plan = plan_compaction(modes_np, len(self.ensemble),
                                   self.acfg.arena_lite_size)
            stats.escalated_rows = plan.escalated_rows
            stats.full_arena_rows = plan.full_arena_rows
            if handle is not None:
                # a task's probe pages are freed the moment its route
                # resolves; only rows some probe-model member will seed
                # its decode from stay retained
                keep: set = set()
                for mi, zm in enumerate(self.ensemble):
                    mp = plan.members[mi]
                    if (self._kv_reuse_member(zm, kv_srv)
                            and self._member_compactable(zm)
                            and mp.bucket < b):
                        keep.update(int(r) for r in mp.rows)
                handle.resolve(sorted(keep))
            member_cols = []
            member_answers: List[List[Optional[str]]] = \
                [[None] * len(self.ensemble) for _ in range(b)]
            reused_rows: set = set()     # (mi, row): probe-page seed
            for mi, zm in enumerate(self.ensemble):
                mp = plan.members[mi]
                col = np.full(b, -1, np.int32)
                if mp.n_rows == 0:
                    member_cols.append(col)
                    continue
                mkey = prng.fold_in_np(key, 1000 + mi)
                srv_m = self._kv_server(zm)
                if self._member_compactable(zm) and mp.bucket < b:
                    rows = mp.padded_rows()
                    mrk = member_row_keys(
                        key, [start_index + int(r) for r in rows], mi)
                    if (handle is not None
                            and self._kv_reuse_member(zm, kv_srv)):
                        # seed from the probe's retained prompt pages:
                        # prefill skipped, logits0 reused, tail COW-forked
                        mout = kv_srv.reuse_decode(
                            self.probe.params, handle, rows.tolist(),
                            max_new_tokens=self.max_new_tokens,
                            temperature=self.acfg.ensemble_temperature,
                            key=mkey, eos_id=tok.EOS, pad_id=tok.PAD,
                            row_keys=mrk)
                        reused_rows.update(
                            (mi, int(r)) for r in mp.rows)
                    else:
                        mout = self._member_decode(zm, srv_m, ids[rows],
                                                   mkey, row_keys=mrk)
                    sub_texts = self._decode_texts(mout.tokens.cpu())
                    for j, r in enumerate(mp.rows):
                        a = extract(sub_texts[j], tasks[r].kind)
                        col[r] = id_table.setdefault(a, len(id_table))
                        member_answers[r][mi] = a
                    decoded_rows = mp.bucket
                else:
                    mout = self._member_decode(
                        zm, srv_m, ids, mkey,
                        row_keys=member_row_keys(key, admission, mi))
                    mtexts = self._decode_texts(mout.tokens.cpu())
                    for r in mp.rows:
                        a = extract(mtexts[r], tasks[r].kind)
                        col[r] = id_table.setdefault(a, len(id_table))
                        member_answers[r][mi] = a
                    decoded_rows = b
                member_cols.append(col)
                stats.bucket_sizes.append(decoded_rows)
                stats.bucket_rows.append(mp.n_rows)
                stats.ensemble_decode_tokens += \
                    decoded_rows * self.max_new_tokens
                stats.ensemble_decode_tokens_saved += \
                    (b - decoded_rows) * self.max_new_tokens
            member_ids = torch.from_numpy(np.stack(member_cols, axis=1))

            final_ids = judge_batch(member_ids, probe_major,
                                    torch.as_tensor(modes_np))
            rev = {v: k for k, v in id_table.items()}
            final_answers = [rev[int(i)] for i in final_ids.tolist()]
            saved = int(np.sum(len(self.ensemble) - np.where(
                modes_np == 0, 0,
                np.where(modes_np == 1, self.acfg.arena_lite_size,
                         len(self.ensemble)))))
            probe_texts = [texts[i * n:(i + 1) * n] for i in range(b)]
            if tracer is not None:
                self._trace_wave(
                    tracer, tasks, start_index, request_ids,
                    int(ids.shape[1]), n, sig.numpy(), modes_np,
                    member_answers, final_answers, reused_rows)
            return BatchResult(
                sigma=sig.numpy(), modes=modes_np,
                final_answers=final_answers, probe_texts=probe_texts,
                ensemble_calls_saved=saved,
                wall_ms=(time.perf_counter() - t0) * 1e3,
                member_answers=member_answers, compaction=stats)
        finally:
            # probe prompt pages must never outlive the batch, even when
            # a member decode raises (close is idempotent)
            if handle is not None:
                handle.close()

    def _trace_wave(self, tracer, tasks, start_index, request_ids,
                    prompt_tokens, n, sig, modes_np, member_answers,
                    final_answers, reused_rows) -> None:
        """Post-hoc span emission for one resolved wave: the lockstep
        wave has no per-tick interleaving, so each task's lifecycle
        spans are stamped at ``tick = admission index`` with the same
        decision fields the step loop records live (structure stays a
        pure function of the admission-ordered run)."""
        from repro_torch.core.attribution import leave_one_out
        from repro_torch.teamllm.spans import make_trace_id
        from repro_torch.teamllm.trace import ModelResponse
        for i, task in enumerate(tasks):
            adm = start_index + i
            rid = request_ids[i] if request_ids is not None \
                else f"task-{task.task_id}"
            trace = make_trace_id(rid, adm)
            sigma = float(sig[i])
            mode = int(modes_np[i])
            tracer.span("admit", trace, adm,
                        prompt_tokens=prompt_tokens, arrival=adm)
            tracer.span("probe_decode", trace, adm,
                        model=self.probe.name, n_samples=n)
            tracer.span("route", trace, adm, sigma=sigma, mode=mode,
                        n_samples=n)
            members = []
            for mi, zm in enumerate(self.ensemble):
                if member_answers[i][mi] is None:
                    continue
                members.append(mi)
                reuse = (mi, i) in reused_rows
                tracer.span("member_launch", trace, adm,
                            key=("m", mi), member=mi, model=zm.name,
                            reuse=int(reuse))
                if reuse:
                    tracer.span("kv_reuse", trace, adm, key=("m", mi),
                                kind="probe", model=zm.name,
                                source=trace)
                tracer.span("member_decode", trace, adm,
                            key=("m", mi), member=mi, model=zm.name,
                            done=1)
            tracer.span("judge", trace, adm, mode=mode,
                        members=members)
            tracer.span("retire", trace, adm, task_id=task.task_id,
                        final_answer=final_answers[i], sigma=sigma,
                        mode=mode, aborted=None)
            if (getattr(tracer, "attribution", False) and mode >= 2
                    and members):
                responses = [
                    ModelResponse(model=self.ensemble[mi].name,
                                  response="",
                                  answer=member_answers[i][mi],
                                  cost=0.0)
                    for mi in members]
                loo = leave_one_out(responses, task.task_id,
                                    task.gold)
                tracer.span("attribution", trace, adm,
                            task_id=task.task_id, mode=mode,
                            values={m: float(v)
                                    for m, v in loo.items()})

    # ------------------------------------------------------------------
    # continuous-batching entry point: admission queue -> micro-batches
    # ------------------------------------------------------------------
    def run_queued(self, tasks: Sequence[Task],
                   policy: MicroBatchPolicy = MicroBatchPolicy(),
                   tracer=None) -> "QueuedServeResult":
        """Serve a request stream through the admission queue: tasks are
        submitted with logical arrival ticks, grouped into micro-batches
        under the policy budget, and each micro-batch runs the batched
        probe -> route -> ensemble pipeline. Per-batch results are
        concatenated in admission order."""
        t0 = time.perf_counter()
        tracer = tracer if (tracer is not None
                            and getattr(tracer, "armed", False)) \
            else None
        queue = AdmissionQueue(policy)
        for t in tasks:
            queue.submit(t)
        metrics = PromCounters()
        compaction = CompactionStats()
        batch_results: List[BatchResult] = []
        batch_sizes: List[int] = []
        for batch in queue.drain_batches():
            res = self.run_batch(
                [r.task for r in batch.requests],
                start_index=batch.requests[0].admission_index,
                tracer=tracer,
                request_ids=[r.request_id for r in batch.requests])
            batch_results.append(res)
            batch_sizes.append(len(batch))
            metrics.inc("acar_engine_batches_total",
                        help="micro-batches decoded")
            metrics.inc("acar_engine_tasks_total", len(batch),
                        help="tasks served")
            metrics.inc("acar_engine_ensemble_calls_saved_total",
                        res.ensemble_calls_saved,
                        help="ensemble decodes avoided by routing")
            for m in res.modes:
                metrics.inc("acar_engine_mode_total",
                            mode=MODE_NAMES[int(m)],
                            help="tasks routed per execution mode")
            cs = res.compaction
            if cs is not None:
                compaction.merge(cs)
                metrics.inc("acar_engine_escalated_rows_total",
                            cs.escalated_rows,
                            help="rows with sigma>0 per wave, summed")
                metrics.inc("acar_engine_full_arena_rows_total",
                            cs.full_arena_rows,
                            help="rows escalated to the full arena")
                metrics.inc(
                    "acar_engine_ensemble_decode_tokens_total",
                    cs.ensemble_decode_tokens,
                    help="ensemble decode tokens actually generated")
                metrics.inc(
                    "acar_engine_ensemble_decode_tokens_saved_total",
                    cs.ensemble_decode_tokens_saved,
                    help="decode tokens the masked full-batch path "
                         "would have generated but compaction skipped")
                metrics.inc(
                    "acar_engine_probe_prefill_tokens_saved_total",
                    cs.probe_prefill_tokens_saved,
                    help="probe prefill tokens elided by shared-prefix "
                         "expansion")
                metrics.inc(
                    "acar_engine_probe_prefill_flops_saved_total",
                    cs.probe_prefill_flops_saved,
                    help="approx. prefill FLOPs saved "
                         "(2 * active params * tokens)")
                for bkt, rows in zip(cs.bucket_sizes, cs.bucket_rows):
                    metrics.inc("acar_engine_bucket_waves_total",
                                bucket=str(bkt),
                                help="member decode waves per shape "
                                     "bucket")
                    metrics.set_gauge(
                        "acar_engine_bucket_occupancy",
                        rows / bkt if bkt else 0.0, bucket=str(bkt),
                        help="escalated-row fill of the last decode "
                             "wave in each shape bucket")
            self._emit_kv_metrics(metrics)
        return QueuedServeResult(
            sigma=np.concatenate([r.sigma for r in batch_results])
            if batch_results else np.zeros(0, np.float32),
            modes=np.concatenate([r.modes for r in batch_results])
            if batch_results else np.zeros(0, np.int32),
            final_answers=[a for r in batch_results
                           for a in r.final_answers],
            batch_sizes=batch_sizes,
            ensemble_calls_saved=sum(r.ensemble_calls_saved
                                     for r in batch_results),
            wall_ms=(time.perf_counter() - t0) * 1e3,
            metrics=metrics, compaction=compaction,
            probe_texts=[p for r in batch_results
                         for p in r.probe_texts],
            member_answers=[m for r in batch_results
                            for m in (r.member_answers or [])],
            kv=self.kv_stats() or None,
            spans=tracer.records() if tracer is not None else None,
            span_head=tracer.flush() if tracer is not None else None)

    # ------------------------------------------------------------------
    # step-level continuous batching entry point
    # ------------------------------------------------------------------
    def run_stepped(self, tasks: Sequence[Task],
                    policy: MicroBatchPolicy = MicroBatchPolicy(), *,
                    chunk_tokens: int = 8,
                    max_active_rows: Optional[int] = None,
                    data_shards: Optional[int] = None,
                    model_shards: int = 1,
                    megastep=1,
                    faults=None,
                    journal_path=None,
                    recovered: Optional[Dict[int, dict]] = None,
                    tracer=None) -> "QueuedServeResult":
        """Serve a request stream through the step-level loop: rows
        admitted from ``AdmissionQueue.ready()`` the moment the page
        budget opens, prompts prefilled in ``chunk_tokens`` chunks,
        probe/ensemble decodes advanced over mixed bucketed batches,
        finished rows retired (pages freed) mid-stream. Per-task
        outputs come back in admission order.

        ``megastep`` runs up to K decode ticks per launch with lane
        state kept on the device; only emitted token ids + done bits
        come back per megastep, and any K emits identical outputs.
        ``megastep="auto"`` runs up to 16 ticks but caps each group's
        span at its shortest remaining lane budget.

        Fault tolerance: ``faults`` (a ``FaultPlan``) attaches a
        deterministic fault injector; ``journal_path`` attaches a
        hash-chained write-ahead ``StepJournal``; ``recovered`` (an
        admission-index -> retire-payload map from
        ``StepJournal.load``) restores already-retired rows verbatim
        while everything else re-executes from scratch — see
        ``recover``. ``tracer`` (serving/tracing.py) attaches span
        tracing: one hashed span per lifecycle transition and fault
        event, which cannot move record hashes or chain heads. Each
        hook costs one attribute check when unset.

        ``data_shards`` switches to the mesh-sharded loop
        (serving/mesh.py): rows placed on the least-loaded shard of a
        ("data",) mesh, per-shard page pools, every shard's bucket in
        one mesh call per group — the same per-task outputs, with
        ``max_active_rows`` interpreted per shard. ``model_shards`` > 1
        widens the mesh to 2-D ("data", "model"): each data shard's
        program runs tensor-parallel across its model columns
        (column-split params, kv-head-split pages — sharding/tp.py).
        Needs ``data_shards * model_shards`` logical devices of the
        engine's kind (``launch.mesh.force_device_count``)."""
        from repro_torch.serving.scheduler import StepPlanner
        from repro_torch.serving.step_loop import (
            ShardedStepLoopRunner, StepLoopRunner)
        if data_shards is None and model_shards != 1:
            raise ValueError(
                "model_shards > 1 requires the sharded loop: "
                "pass data_shards as well")
        t0 = time.perf_counter()
        injector = None
        if faults is not None:
            from repro_torch.serving.faults import FaultInjector
            injector = FaultInjector(faults)
        journal = None
        if journal_path is not None:
            from repro_torch.serving.journal import StepJournal
            journal = StepJournal(journal_path, injector=injector)
        queue = AdmissionQueue(policy)
        for t in tasks:
            queue.submit(t)
        rows_cap = max_active_rows or policy.max_batch_size
        if megastep == "auto":
            planner = StepPlanner(chunk_tokens=chunk_tokens,
                                  max_active_rows=rows_cap,
                                  megastep=16, megastep_auto=True)
        else:
            planner = StepPlanner(chunk_tokens=chunk_tokens,
                                  max_active_rows=rows_cap,
                                  megastep=megastep)
        metrics = PromCounters()
        smesh = None
        if data_shards is None:
            runner = StepLoopRunner(self, queue, planner, metrics,
                                    faults=injector, journal=journal,
                                    recovered=recovered, tracer=tracer)
        else:
            from repro_torch.serving.mesh import ServingMesh
            smesh = ServingMesh(data=data_shards, model=model_shards)
            runner = ShardedStepLoopRunner(
                self, queue, planner, smesh, metrics, faults=injector,
                journal=journal, recovered=recovered, tracer=tracer)
        try:
            step_stats = runner.run()
        finally:
            if smesh is not None:
                smesh.close()
        # the last sharded run's servers, for per-shard page accounting
        self._mesh_servers = list(getattr(runner, "_sharded", {}).values())
        # the sharded runner's servers are its own, not the engine's:
        # emit the pool gauges and reuse counters of whichever set
        # served the run
        self._emit_kv_metrics(metrics, kv=runner.kv_stats())

        rows = [runner.done_rows[i] for i in range(len(tasks))]
        saved = sum(
            len(self.ensemble) - sum(
                1 for mi in range(len(self.ensemble))
                if r.mode >= (1 if mi < self.acfg.arena_lite_size
                              else 2))
            for r in rows)
        admit_ticks: Dict[int, int] = {}
        for a, (_, adm, _) in sorted(step_stats.timeline.items()):
            admit_ticks[adm] = admit_ticks.get(adm, 0) + 1
        return QueuedServeResult(
            sigma=np.asarray([r.sigma for r in rows], np.float32),
            modes=np.asarray([r.mode for r in rows], np.int32),
            final_answers=[r.final_answer for r in rows],
            batch_sizes=[v for _, v in sorted(admit_ticks.items())],
            ensemble_calls_saved=saved,
            wall_ms=(time.perf_counter() - t0) * 1e3,
            metrics=metrics,
            probe_texts=[r.probe_texts or [] for r in rows],
            member_answers=[r.member_answers or
                            [None] * len(self.ensemble)
                            for r in rows],
            kv=runner.kv_stats() or None,
            step=step_stats,
            faults=runner.fault_events or None,
            restored_rows=step_stats.restored,
            spans=runner.tracer.records()
            if runner.tracer is not None else None,
            span_head=runner.tracer.flush()
            if runner.tracer is not None else None)

    def recover(self, tasks: Sequence[Task],
                policy: MicroBatchPolicy = MicroBatchPolicy(), *,
                journal_path, chunk_tokens: int = 8,
                max_active_rows: Optional[int] = None,
                data_shards: Optional[int] = None,
                model_shards: int = 1,
                megastep=1, tracer=None) -> "QueuedServeResult":
        """Resume a killed ``run_stepped`` run from its write-ahead
        journal: rows with a durable ``retire`` event are restored
        verbatim; in-flight and unadmitted rows re-execute from
        scratch with their original admission indices, so the
        recovered run's record hashes and artifact-chain heads are
        byte-identical to an uninterrupted run's. Must be called with
        the same task stream, policy and engine config as the killed
        run."""
        from repro_torch.serving.journal import StepJournal
        state = StepJournal.load(journal_path)
        return self.run_stepped(
            tasks, policy, chunk_tokens=chunk_tokens,
            max_active_rows=max_active_rows, data_shards=data_shards,
            model_shards=model_shards, megastep=megastep,
            recovered=state.retired, tracer=tracer)

    def _emit_kv_metrics(self, metrics: PromCounters,
                         kv: Optional[Dict[str, KVStats]] = None
                         ) -> None:
        """Paged-KV exposition: pool gauges plus monotonic prefill-reuse
        counters (deltas since the last emission, so repeated runs on
        one engine stay cumulative). ``kv`` overrides the stats source
        (the sharded step loop's servers, aggregated per model)."""
        for st in (kv if kv is not None else self.kv_stats()).values():
            metrics.set_gauge(
                "acar_kv_pages_in_use", st.pages_in_use,
                model=st.model,
                help="KV pool pages currently referenced")
            metrics.set_gauge(
                "acar_kv_pages_highwater", st.pages_highwater,
                model=st.model,
                help="KV pool pages-in-use peak since server creation")
            for source, value in (
                    ("probe", st.prefill_tokens_reused_probe),
                    ("prefix_cache", st.prefill_tokens_reused_prefix)):
                k = (st.model, source)
                delta = value - self._kv_emitted.get(k, 0)
                if delta:
                    metrics.inc(
                        "acar_kv_prefill_tokens_reused_total", delta,
                        model=st.model, source=source,
                        help="prefill tokens served from retained "
                             "pages instead of recomputation")
                    self._kv_emitted[k] = value


@dataclass
class QueuedServeResult:
    """Concatenated (admission-order) result of a served stream."""
    sigma: np.ndarray
    modes: np.ndarray
    final_answers: List[str]
    batch_sizes: List[int]
    ensemble_calls_saved: int
    wall_ms: float
    metrics: Optional[object] = field(default=None, repr=False)
    compaction: Optional[CompactionStats] = None
    probe_texts: Optional[List[List[str]]] = None
    member_answers: Optional[List[List[Optional[str]]]] = None
    # paged-KV accounting per model server
    kv: Optional[Dict[str, KVStats]] = None
    # step-loop accounting
    step: Optional[object] = None
    # fault-path events (retries, quarantines, degraded routes,
    # aborts) in firing order; None on fault-free runs
    faults: Optional[List[dict]] = None
    # rows restored verbatim from a step journal by ``recover``
    restored_rows: int = 0
    # deterministic span records + chain head when a tracer was armed
    # (serving/tracing.py); None otherwise
    spans: Optional[List[dict]] = None
    span_head: Optional[str] = None
