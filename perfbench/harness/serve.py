"""The system under test: one ``BatchedACAREngine`` of a configuration's
fleet, driven stream by stream through ``run_stepped``.

The step loop keeps a row's token ids only until it reads the answer
out of them. ``recording_runner`` returns a subclass of the loop that
copies them first, where the loop harvests each probe sample and each
member decode, with what the FLOP count needs (prefix-cache hits, the
twin's reuse of the probe's pages). It changes nothing the loop
computes. ``engine.run_stepped`` looks the loop up in its module at
each call, so ``Fleet`` installs the subclass there for its lifetime.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from perfbench.harness import traffic as traffic_mod
from perfbench.harness.weights import fleet_weights


@dataclass
class TaskRecord:
    """What one served task produced, as the loop harvested it."""
    probe_tokens: List[List[int]] = field(default_factory=list)
    probe_from_cache: bool = False
    member_tokens: Dict[int, List[int]] = field(default_factory=dict)
    # member index -> "reuse" (the probe's pages), "cache" (a prefix
    # hit) or "prefill" (its own prefill)
    member_prefill: Dict[int, str] = field(default_factory=dict)


def recording_runner(base, records: dict, hooks: dict):
    """A subclass of the step loop ``base`` that fills ``records``
    (admission index -> ``TaskRecord``), calls ``hooks["tick"]``, where
    set, with the loop at the start of each tick, and enters
    ``hooks["phase"]``, where set, around each phase of a tick."""

    class RecordingRunner(base):
        def _rec(self, row) -> TaskRecord:
            return records.setdefault(row.admission, TaskRecord())

        def _route(self, rows):
            for row in rows:
                rec = self._rec(row)
                rec.probe_tokens = [list(l.tokens) for l in row.lanes]
                rec.probe_from_cache = bool(row.from_cache)
            return super()._route(rows)

        def _finish_members(self, row):
            for mx in row.members:
                lane = mx.lane
                if (mx.answer is None and lane is not None
                        and (lane.done or lane.steps >= self.max_new)):
                    rec = self._rec(row)
                    rec.member_tokens[mx.member] = list(lane.tokens)
                    rec.member_prefill[mx.member] = (
                        "reuse" if mx.reuse else
                        "cache" if mx.from_cache else "prefill")
            return super()._finish_members(row)

        def _phase(self, name, fn, *args):
            phase = hooks.get("phase")
            if phase is None:
                return fn(*args)
            with phase(name):
                return fn(*args)

        def _admit_ready(self):
            tick = hooks.get("tick")
            if tick is not None:
                tick(self)
            return self._phase("admit", super()._admit_ready)

        def _run_prefill_group(self, key, items):
            return self._phase("prefill", super()._run_prefill_group,
                               key, items)

        def _run_decode_group(self, key, items):
            return self._phase("decode", super()._run_decode_group,
                               key, items)

        def _promote(self):
            return self._phase("promote", super()._promote)

    return RecordingRunner


@dataclass
class StreamResult:
    index: int
    tasks: list
    routes: np.ndarray
    result: object                 # repro_torch's QueuedServeResult
    records: Dict[int, TaskRecord]
    wall_s: float


def model_config(m: dict, name: str):
    """The port's ``ModelConfig`` of a configuration file's model."""
    from repro_torch.configs.base import ModelConfig, SSMConfig
    fields = dict(m)
    if "ssm" in fields:
        fields["ssm"] = SSMConfig(**fields["ssm"])
    return ModelConfig(name=name, **fields)


class Fleet:
    """One engine over a configuration's fleet, and the streams it
    serves. Use as a context manager: it installs the recording loop
    and takes it out again."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from repro_torch.configs.acar import ACARConfig
        from repro_torch.serving import BatchedACAREngine, ZooModel
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.weights = fleet_weights(config, seed, self.device)
        cfgs = {name: model_config(m, name)
                for name, m in config["models"].items()}

        def zoo(entry):
            return ZooModel(entry["name"], cfgs[entry["model"]],
                            self.weights[(entry["model"], entry["weights"])])

        self.probe = zoo(config["probe"])
        self.ensemble = [zoo(e) for e in config["ensemble"]]
        self.routes = np.zeros(0, np.int32)

        def route(sig, indices):
            return self.routes[np.asarray(indices, np.int64)]

        self.engine = BatchedACAREngine(
            ACARConfig(seed=self.seed % (1 << 31)), self.probe,
            self.ensemble, max_new_tokens=int(traffic["new_tokens"]),
            kv_page_size=int(config["kv_page_size"]),
            kv_prefix_cache=int(config["kv_prefix_cache"]),
            route_fn=route, device=self.device)
        self.records: Dict[int, TaskRecord] = {}
        self.hooks: dict = {}
        self.max_active_rows = self._rows_that_fit()

    # -- sizing ---------------------------------------------------------
    def _servers(self):
        """(server, lanes a row holds on it) of every distinct page
        server, as the step loop sizes them: the probe's carries its N
        samples and the twins' seeded decodes, each other server one
        decode lane a row."""
        eng = self.engine
        probe_srv = eng._stepped_server(eng.probe)
        twins = sum(1 for zm in eng.ensemble
                    if zm is not eng.probe
                    and eng._stepped_server(zm) is probe_srv)
        out = [(probe_srv, eng.acfg.n_probe_samples + max(twins, 1))]
        for zm in eng.ensemble:
            srv = eng._stepped_server(zm)
            if srv is not None and all(srv is not s for s, _ in out):
                out.append((srv, 1))
        return out

    def _rows_that_fit(self) -> int:
        """The most rows whose worst case (the mix's longest prompt) fits
        in the configuration's pool budget, by the pools' own sizing:
        each server's pages for that many rows, its prefix cache and its
        scratch pages; no more than the configuration's
        ``max_active_rows``, where it sets one."""
        s = max(self.traffic["prompt_tokens"]["snap_to"])
        m = int(self.traffic["new_tokens"])
        fixed = per_row = 0
        for srv, lanes in self._servers():
            g = srv.row_geometry(s, m)
            page = srv.stats.page_bytes
            per_row += srv.stream_row_pages(s, lanes, m) * page
            fixed += (srv.prefix_cache_entries * g.nbp + g.nb) * page
        budget = float(self.config["pool_budget_gib"]) * 2 ** 30
        rows = int((budget - fixed) // per_row)
        rows = min(rows, int(self.config.get("max_active_rows", rows)))
        if rows < 1:
            raise ValueError(f"{self.config['name']}: no row fits in "
                             f"{self.config['pool_budget_gib']} GiB")
        return rows

    # -- serving --------------------------------------------------------
    def __enter__(self):
        from repro_torch.serving import step_loop
        self._step_loop = step_loop
        self._base = step_loop.StepLoopRunner
        step_loop.StepLoopRunner = recording_runner(
            self._base, self.records, self.hooks)
        return self

    def __exit__(self, *exc):
        self._step_loop.StepLoopRunner = self._base
        return False

    def tasks_of(self, index: int, warmup: bool = False):
        """Stream ``index``'s tasks and routes; the warm-up's are its
        ``max_active_rows`` longest prompts, longest first, each routed
        to the full arena so that every member's path runs."""
        from repro_torch.data.tasks import Task
        st, routes = traffic_mod.stream(self.traffic, self.seed, index)
        if warmup:
            st, routes = traffic_mod.longest_first(st, routes)
            st = st[:self.max_active_rows]
            routes = np.full(len(st), 2, np.int32)
        made: Dict[str, Task] = {}
        tasks = []
        for t in st:
            if t.task_id not in made:
                made[t.task_id] = Task(
                    task_id=t.task_id, benchmark="perfbench", kind=t.kind,
                    text=t.text, gold="0", difficulty=0.0)
            tasks.append(made[t.task_id])
        return tasks, routes

    def serve(self, index: int, warmup: bool = False) -> StreamResult:
        """Serve stream ``index`` through ``run_stepped``, the clock
        stopped once the card has finished."""
        from repro_torch.serving import MicroBatchPolicy
        tasks, routes = self.tasks_of(index, warmup)
        self.routes = routes
        self.records.clear()
        policy = MicroBatchPolicy(max_batch_size=self.max_active_rows,
                                  max_batch_tokens=1 << 30)
        t0 = time.perf_counter()
        res = self.engine.run_stepped(
            tasks, policy, chunk_tokens=int(self.traffic["chunk_tokens"]),
            max_active_rows=self.max_active_rows,
            megastep=int(self.traffic["megastep"]))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        return StreamResult(index, tasks, routes, res, dict(self.records),
                            wall)

    def close(self) -> None:
        """Free the program's state (page pools, caches); the weights
        are the benchmark's and stay."""
        self.engine = None
        self.probe = self.ensemble = None


def step_totals(streams: List[StreamResult]) -> dict:
    """StepStats counters summed over streams."""
    keys = ("ticks", "launches", "prefill_chunks", "retired",
            "masked_decode_steps", "decode_tokens", "admissions")
    return {k: sum(getattr(s.result.step, k) for s in streams) for k in keys}


def kv_totals(fleet: Fleet) -> Dict[str, dict]:
    """Each page server's pool size and high-water mark (pages)."""
    out = {}
    for srv, _ in fleet._servers():
        st = srv.stats
        out[st.model] = {"pool_pages": st.pool_pages,
                         "pages_highwater": st.pages_highwater,
                         "page_bytes": st.page_bytes}
    return out
