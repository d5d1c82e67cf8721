"""The port's continuous-batching scheduler
(``repro_torch.serving.scheduler``) against the reference's, on the
CPU over each package's calibrated synthetic backends
(``core.backends.paper_backends``): the probe cache on its own, then a
seeded request stream with duplicate resubmissions through both
schedulers at several batch sizes, with the probe wave prefetched and
not, with retrieval from an experience store, with host routing and
under each virtual KV page layout. Modes, final answers, record hashes,
chain heads, ``logical_time``, cache hits, every ``SchedulerStats``
field but the host wall, and the rendered Prometheus text must be
equal; and the port's scheduler against the port's sequential
orchestrator over the same stream: equal record hashes and heads (the
scheduler is an execution strategy, not a semantic change)."""
import dataclasses

import pytest

from _torch_port import check_scheduler_against_reference, torch_task
from harness.simulate import WorkloadConfig, generate_workload
from repro.configs import acar as j_acar
from repro.serving import scheduler as j_sched
from repro_torch.configs import acar as t_acar
from repro_torch.core import backends as t_back
from repro_torch.serving import scheduler as t_sched

PROBE = "gemini-2.0-flash"


@pytest.fixture(scope="module")
def stream():
    """24 tasks of the paper mix, about a third resubmissions (probe
    cache traffic)."""
    ref = generate_workload(WorkloadConfig(n_tasks=24, seed=3,
                                           duplicate_rate=0.35))
    assert len({t.task_id for t in ref}) < len(ref)
    return ref, [torch_task(t) for t in ref]


# ----------------------------------------------------------------------
# the probe cache
# ----------------------------------------------------------------------
def _cache_ops(mod, capacity):
    """One sequence of inserts and lookups; returns what each lookup
    saw, the hits, misses and size."""
    cache = mod.ProbeCache(capacity)
    seen = []
    for k in ("a", "b", "a", "c", "d", "b", "a", "e", "c"):
        entry = cache.lookup(k)
        seen.append(None if entry is None else entry.probe_latency)
        if entry is None:
            cache.insert(k, mod._ProbeEntry([], [], float(ord(k))))
    return seen, cache.hits, cache.misses, len(cache)


@pytest.mark.parametrize("capacity", [0, 1, 2, 3, 512])
def test_probe_cache_matches_reference(capacity):
    got = _cache_ops(t_sched, capacity)
    assert got == _cache_ops(j_sched, capacity)
    seen, hits, misses, size = got
    assert hits + misses == len(seen)
    assert size == min(capacity, 5)
    if capacity == 0:
        assert hits == 0
    if capacity == 2:
        # LRU: "a" refreshed by its hit survives "c"; "b" does not
        assert seen[2] is not None and seen[5] is None


def test_probe_cache_key_covers_generation_identity(stream):
    _, ttasks = stream
    task = ttasks[0]
    other = next(t for t in ttasks if t.task_id != task.task_id)
    acfg = t_acar.ACARConfig()
    base = t_sched.ProbeCache.key(task, "p", acfg)
    assert base == j_sched.ProbeCache.key(stream[0][0], "p",
                                          j_acar.ACARConfig())
    variants = [
        t_sched.ProbeCache.key(other, "p", acfg),
        t_sched.ProbeCache.key(task, "q", acfg),
        t_sched.ProbeCache.key(task, "p", dataclasses.replace(
            acfg, n_probe_samples=5)),
        t_sched.ProbeCache.key(task, "p", dataclasses.replace(
            acfg, probe_temperature=0.3)),
        t_sched.ProbeCache.key(task, "p", dataclasses.replace(
            acfg, seed=7))]
    assert len({base, *variants}) == 6


# ----------------------------------------------------------------------
# the scheduler, port against reference and against the port's
# orchestrator (``_torch_port.check_scheduler_against_reference``)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "serial"])
@pytest.mark.parametrize("batch", [1, 3, 8])
def test_scheduler_matches_reference(tmp_path, stream, batch, overlap):
    ts, touts = check_scheduler_against_reference(stream[0], tmp_path,
                                                  batch, overlap)
    assert ts.stats.batches == -(-len(touts) // batch)
    assert ts.cache.hits > 0
    assert {o.trace.mode for o in touts} == {
        "single_agent", "arena_lite", "full_arena"}
    if overlap and batch < len(touts):
        assert ts.stats.speedup_vs_sequential > 1.0


@pytest.mark.parametrize("batch", [3, 8])
def test_scheduler_with_experience_matches_reference(tmp_path, stream,
                                                     batch):
    _, touts = check_scheduler_against_reference(stream[0], tmp_path,
                                                 batch, retrieval=True)
    assert all(o.trace.retrieval["hit"] for o in touts)


@pytest.mark.parametrize("kw", [
    dict(device_routing=False), dict(kv_layout="quant"),
    dict(kv_layout="ring", kv_window=12), dict(kv_layout="lanes"),
    dict(kv_page_size=4, kv_decode_tokens=6, probe_cache_size=2)],
    ids=["host-routing", "quant", "ring", "lanes", "pages4-cache2"])
def test_scheduler_knobs_match_reference(tmp_path, stream, kw):
    ts, _ = check_scheduler_against_reference(stream[0], tmp_path, 3, **kw)
    assert ts.stats.kv_pages_highwater > 0


def test_scheduler_rejects_bad_layouts():
    backends = t_back.paper_backends()
    for kw in (dict(kv_layout="paged"), dict(kv_layout="ring")):
        with pytest.raises(ValueError):
            t_sched.ContinuousBatchingScheduler(
                t_acar.ACARConfig(), backends[PROBE], backends, **kw)


def test_scheduler_over_model_backends_matches_reference(tmp_path):
    """Real models behind the scheduler: the reference's over
    ``JaxModelBackend``s and the port's over ``TorchModelBackend``s (the
    reduced f32 ``paged_zoo``: probe, two members, the probe's twin)
    serve 8 arithmetic tasks and a resubmission in micro-batches of 4,
    the port's probe wave of batch k+1 on the prefetch thread while
    batch k's members run. Equal record hashes, schedules and heads,
    cache hits and metric names (the values hold host latencies); the
    port's head equal to its orchestrator's over the same backends."""
    from _torch_port import one_torch_thread, pallas_zoo, torch_zoo
    from harness.simulate import paged_zoo
    from repro.data.tasks import arithmetic_suite
    from repro.serving import JaxModelBackend
    from repro.serving import MicroBatchPolicy as JPolicy
    from repro.teamllm.artifacts import ArtifactStore as JStore
    from repro_torch.core import ACAROrchestrator
    from repro_torch.serving import MicroBatchPolicy, TorchModelBackend
    from repro_torch.teamllm.artifacts import ArtifactStore as TStore

    probe, ensemble = paged_zoo(seed=0)
    jprobe, jens = pallas_zoo(probe, ensemble)
    tprobe, tens = torch_zoo(probe, ensemble)
    jb = [JaxModelBackend(z.name, z.cfg, z.params) for z in [jprobe] + jens]
    tb = [TorchModelBackend(z.name, z.cfg, z.params)
          for z in [tprobe] + tens]
    tasks = arithmetic_suite(8, seed=0)
    tasks.append(tasks[2])
    ttasks = [torch_task(t) for t in tasks]
    cfg = dict(probe_temperature=0.9, seed=0)
    js = j_sched.ContinuousBatchingScheduler(
        j_acar.ACARConfig(**cfg), jb[0], {b.name: b for b in jb[1:]},
        store=JStore(tmp_path / "j.jsonl"), run_id="models",
        policy=JPolicy(max_batch_size=4))
    ts = t_sched.ContinuousBatchingScheduler(
        t_acar.ACARConfig(**cfg), tb[0], {b.name: b for b in tb[1:]},
        store=TStore(tmp_path / "t.jsonl"), run_id="models",
        policy=MicroBatchPolicy(max_batch_size=4))
    with one_torch_thread():
        jouts, touts = js.serve(tasks), ts.serve(ttasks)
        seq = ACAROrchestrator(
            t_acar.ACARConfig(**cfg), tb[0], {b.name: b for b in tb[1:]},
            store=TStore(tmp_path / "seq.jsonl"), run_id="models"
        ).run_suite(ttasks)
    for j, t in zip(jouts, touts):
        assert t.trace.hashed_view() == j.trace.hashed_view()
        assert t.trace.record_hash() == j.trace.record_hash()
        assert t.trace.schedule == j.trace.schedule
    assert [o.trace.record_hash() for o in seq] == \
        [o.trace.record_hash() for o in touts]
    heads = [a(p).audit() for a, p in (
        (JStore, tmp_path / "j.jsonl"), (TStore, tmp_path / "t.jsonl"),
        (TStore, tmp_path / "seq.jsonl"))]
    assert all(h["ok"] and h["records"] == len(tasks) for h in heads)
    assert heads[0]["head"] == heads[1]["head"] == heads[2]["head"]
    assert ts.cache.hits == js.cache.hits == 1
    assert ts.stats.batches == 3
    assert {o.trace.mode for o in touts} != {"single_agent"}
    names = [[ln.rsplit(" ", 1)[0] for ln in s.render_metrics().splitlines()]
             for s in (js, ts)]
    assert names[0] == names[1]
