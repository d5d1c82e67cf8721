"""Batched ACAR serving engine — Algorithm 1 of the paper over real
models, served by the step-level loop.

The port of ``repro/serving/engine.py`` for the stepped main path: the
probe's N samples decode over shared prompt pages, sigma over the
interned probe answers routes each task (single / arena-lite /
full-arena), only the escalated tasks decode on the ensemble members
(the probe's twin reuses the probe's pages), and the judge aggregates.
Answers are canonicalised on the host (``core.extract``) and interned
to int32 ids; sigma, routing and the judge run as tensor math over the
ids. The wave engines (``run_batch``/``run_queued``), fault injection,
journaling, recovery and tracing are not ported yet.
"""
from __future__ import annotations

import inspect
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.acar import ACARConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.core.sigma import route_batch
from repro_torch.data.tasks import Task
from repro_torch.models.transformer import resolve_layout
from repro_torch.serving.kv_pool import KVStats, PagedKVServer
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

    two_agree = ((member_ids[:, 0] == member_ids[:, 1])
                 & valid[:, 0] & valid[:, 1])
    lite = torch.where(two_agree & (member_ids[:, 0] != probe_majority),
                       member_ids[:, 0], probe_majority)

    return torch.where(modes == 0, probe_majority,
                       torch.where(modes == 1, lite, plural))


def _deterministic_cuda() -> None:
    """Serving on the card: full-precision float32 matmuls (TF32 off for
    matmuls and cuDNN) and deterministic algorithms, so a rerun of a
    stream reproduces its answers."""
    # cuBLAS is deterministic only with a fixed workspace configuration
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)


class BatchedACAREngine:
    """Batched ACAR engine over real zoo models.

    ``route_fn`` overrides sigma->mode routing (benchmarks use it to
    force escalation rates). Page pools live on ``device``; the models'
    params must already be there."""

    def __init__(self, acfg: ACARConfig, probe: ZooModel,
                 ensemble: Sequence[ZooModel], max_new_tokens: int = 8,
                 kv_page_size: int = 8,
                 kv_prefix_cache: int = 32,
                 route_fn: Optional[Callable] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.acfg = acfg
        self.probe = probe
        self.ensemble = list(ensemble)
        self.max_new_tokens = max_new_tokens
        self.kv_page_size = kv_page_size
        self.kv_prefix_cache = kv_prefix_cache
        self.device = torch.device(device)
        if self.device.type == "cuda":
            _deterministic_cuda()
        self._kv_servers: Dict[int, PagedKVServer] = {}
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
        function of params, not just configs)."""
        if resolve_layout(zm.cfg) is None:
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
        """Server for the step-level loop (the same object as
        ``_kv_server``: ``_kv_reuse_member`` compares servers by
        identity)."""
        return self._kv_server(zm)

    def kv_stats(self) -> Dict[str, KVStats]:
        """Measured paged-KV accounting per model server."""
        return {srv.stats.model: srv.stats
                for srv in self._kv_servers.values()}

    def _kv_reuse_member(self, zm: ZooModel,
                         kv_srv: Optional[PagedKVServer]) -> bool:
        return (kv_srv is not None and zm.cfg == self.probe.cfg
                and self._kv_server(zm) is kv_srv)

    def _member_compactable(self, zm: ZooModel) -> bool:
        """Seeding a member's decode from the probe's pages must not
        perturb its rows: greedy decode of a batch-invariant (non-MoE)
        config."""
        return (self.acfg.ensemble_temperature <= 0.0
                and zm.cfg.moe is None)

    def route_modes(self, sig, admission_indices):
        """Invoke route_fn, passing admission indices when it wants
        them (forced-rate benchmarks key modes off task identity)."""
        if self._route_takes_indices:
            return self.route_fn(sig, list(admission_indices))
        return self.route_fn(sig)

    # ------------------------------------------------------------------
    # step-level continuous batching entry point
    # ------------------------------------------------------------------
    def run_stepped(self, tasks: Sequence[Task],
                    policy: MicroBatchPolicy = MicroBatchPolicy(), *,
                    chunk_tokens: int = 8,
                    max_active_rows: Optional[int] = None,
                    data_shards: Optional[int] = None,
                    megastep=1,
                    faults=None,
                    journal_path=None,
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

        ``data_shards``, ``faults``, ``journal_path`` and ``tracer``
        are not ported yet and raise ``NotImplementedError``."""
        from repro_torch.serving.scheduler import StepPlanner
        from repro_torch.serving.step_loop import StepLoopRunner
        for name, value in (("data_shards", data_shards),
                            ("faults", faults),
                            ("journal_path", journal_path),
                            ("tracer", tracer)):
            if value is not None:
                raise NotImplementedError(
                    f"run_stepped({name}=...) is not ported yet")
        t0 = time.perf_counter()
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
        runner = StepLoopRunner(self, queue, planner, metrics)
        step_stats = runner.run()
        self._emit_kv_metrics(metrics)

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
            step=step_stats)

    def _emit_kv_metrics(self, metrics: PromCounters) -> None:
        """Paged-KV exposition: pool gauges plus monotonic prefill-reuse
        counters (deltas since the last emission, so repeated runs on
        one engine stay cumulative)."""
        for st in self.kv_stats().values():
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
    probe_texts: Optional[List[List[str]]] = None
    member_answers: Optional[List[List[Optional[str]]]] = None
    # paged-KV accounting per model server
    kv: Optional[Dict[str, KVStats]] = None
    # step-loop accounting
    step: Optional[object] = None
